"""Native (C++) runtime components of the port, built with g++ on first
use (`build.py`): `coord.cpp`, the host rendezvous, barriers and peer
liveness that `runtime/native_coord.py` loads. The source is a copy of
the JAX package's `hyperion_tpu/native/coord.cpp`; nothing here imports
that package."""
