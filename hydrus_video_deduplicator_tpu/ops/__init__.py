"""Device compute for the hot paths of the search.

- :mod:`.similarity`          — bit-packed Hamming / ±1 int8 similarity primitives.
- :mod:`.similarity_segments` — the fixed-shape segment kernels (plain XLA, and
  the stage-A existence kernel written for the GPU in Pallas through Triton).
- :mod:`.pair_verify`         — batched exact verification of candidate pairs.
- :mod:`.reps`                — scene representatives for the exact prune.
"""
