"""Training: losses, optimizer and state, the train step, the trainer."""
