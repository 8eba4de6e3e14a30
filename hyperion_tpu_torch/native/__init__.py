"""Native (C++) runtime components of the port, built with g++ on first
use (`build.py`): `coord.cpp`, the host rendezvous, barriers and peer
liveness that `runtime/native_coord.py` loads, and `recordio.cpp`, the
memory-mapped fixed-record store that `data/recordio.py` loads. The
sources are copies of the JAX package's `hyperion_tpu/native/`; nothing
here imports that package."""
