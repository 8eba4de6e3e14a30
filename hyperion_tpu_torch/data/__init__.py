"""Data: the tokenized-text sources and one-device batching."""
