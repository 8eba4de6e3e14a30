"""The distributed runtime of the port — `hyperion_tpu/runtime/`:
process groups with the host coordinator (`dist`, `native_coord`), the
device mesh (`mesh`) and the collectives' check (`comm_check`)."""
