"""hydrus_video_deduplicator_tpu — an accelerated perceptual video-deduplication framework.

Re-implements the full capability surface of hydrusvideodeduplicator (reference:
the reference, v0.11.2) with a JAX device path (an NVIDIA GPU today):

- ``vpdq``      — the PDQ/VPDQ perceptual hash: shared exact-math constants, a pure
                  numpy oracle, and the canonical ``VpdqHash`` value type.
- ``native``    — C++ CPU implementation (threaded VideoHasher, matchHash) loaded
                  via ctypes; the bit-exactness oracle and the no-device fallback.
- ``models``    — the hash pipeline expressed as pure JAX (XLA) functions.
- ``ops``       — device compute for the search (bit-packed int8 Hamming
                  similarity, segment kernels, pair verification).
- ``parallel``  — multi-device sharding: mesh construction and the sharded
                  all-pairs similarity engine (shard_map over a 1-D mesh).
- ``device``    — every platform decision, in one place.
- ``decode``    — video decode + 1 fps frame sampling + 512x512 nearest rescale
                  (OpenCV / Pillow-animation / Y4M backends).
- ``db``        — SQLite persistence, schema-compatible with the reference
                  (videohashes.sqlite), including the VP-tree and migrations.
- ``client``    — Hydrus Client API library + HVDClient wrapper.
- ``dedup``     — the 4-stage resumable orchestrator.
- ``entrypoint``— the CLI (same flag surface as the reference).
"""

from .__about__ import __version__  # noqa: F401
