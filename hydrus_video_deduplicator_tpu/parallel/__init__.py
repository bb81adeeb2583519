"""Multi-device sharding: mesh construction and the sharded all-pairs engine.

- :mod:`.mesh`   — mesh helpers (1-D mesh over the visible devices).
- :mod:`.engine` — the device similarity search engine: exact all-pairs VPDQ
  similarity over bucketed, bit-packed corpora, tiled on one chip and
  row-sharded across a mesh (``shard_map``) on many.
"""

from .engine import TpuSearchEngine, CorpusIndex  # noqa: F401
from .mesh import build_mesh, device_count  # noqa: F401
