#!/usr/bin/env python3
"""Kernel timings on the card: the numbers behind PERF.md's kernel table.

Times, on one GPU, at the engine's production block shapes:

- the stage-A existence sweep of one row tile (2 row blocks, 4,096 frames)
  against a column corpus of --tiles engine tiles (16,384 frames each):
  the Triton kernel in one launch (the engine's one-call route) against
  the plain-XLA twin under the engine's lax.scan route, both through the
  engine's own jitted sweep functions;
- the engine's whole pruned search (find_pairs_pruned) over a
  scene-profile library, with stage A on each of the two;
- the unpruned segment route's score program (plain XLA) per row tile;
- the XLA PDQ hash program at the 512-frame device batch, and the
  host-to-device copy of such a batch;
- reference rates of the card: a large int8 and bf16 matrix product and a
  large device copy.

Every time is the mean over --iters calls after a warm-up call, waited
for with block_until_ready. A summary of the GEMM custom calls in the
optimized HLO of the XLA twin's sweep is part of the results; --hlo-out
writes the whole HLO to a file. Prints the card's name and power limit,
then one JSON line of results.

Usage:  python bench.py [--tiles N] [--iters N] [--e2e-videos N] [--hlo-out PATH]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def timed(fn, iters: int) -> float:
    """Mean seconds per call of fn() after one warm-up call."""
    import jax

    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    out = None
    for _ in range(iters):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tiles", type=int, default=64, help="column tiles of 16,384 frames")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--e2e-videos", type=int, default=20_000,
                    help="scene-profile library size of the end-to-end pruned search")
    ap.add_argument("--hlo-out", help="write the XLA twin sweep's optimized HLO here")
    args = ap.parse_args(argv)
    os.environ["JAX_PLATFORMS"] = "cuda"
    sys.path.insert(0, str(ROOT))

    import jax
    import jax.numpy as jnp
    import numpy as np

    from hydrus_video_deduplicator_tpu import device
    from hydrus_video_deduplicator_tpu.models import pdq as mpdq
    from hydrus_video_deduplicator_tpu.ops import reps
    from hydrus_video_deduplicator_tpu.ops import similarity_segments as seg
    from hydrus_video_deduplicator_tpu.parallel import engine

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX found {jax.devices()}")
    device.enable_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    res: dict = {"card": card, "kind": dev.device_kind, "iters": args.iters}
    rng = np.random.default_rng(0)

    # --- stage-A existence sweep at production shapes ---------------------
    T = args.tiles
    rb = seg.TILE_ROW_BLOCKS
    tile_f = seg.TILE_COL_STEPS * seg.STEP_FRAMES
    tile_s = seg.TILE_COL_STEPS * seg.STEP_SLOTS
    # packed operands as the engine ships them: rows bit-packed in one blob,
    # columns ±1-expanded and stacked [T, tile_frames, 256]
    r_packed = rng.integers(0, 2**32, (rb * seg.ROW_FRAMES, seg.LANES), dtype=np.uint64).astype(np.uint32)
    r_ids = np.tile((np.arange(seg.ROW_FRAMES) // 8).astype(np.int32), rb)
    r_cnt = np.full((rb * seg.ROW_SLOTS, 1), 8, np.int32)
    rblob = jnp.asarray(engine._pack_row_blob(r_packed, r_ids, r_cnt, rb))
    c_packed = jax.random.bits(jax.random.PRNGKey(1), (T, tile_f, seg.LANES), jnp.uint32)
    ci = jnp.asarray(np.tile(((np.arange(tile_f) % seg.CHUNK_FRAMES) // 8).astype(np.int32), (T, 1)))
    cf = seg.unpack_blocks_pm1_stacked(c_packed, ci)
    cc = jnp.full((T, tile_s, 1), 8, jnp.int32)
    valid = jnp.ones((T,), bool)
    tol = reps.prune_tolerance()
    min_sim = jnp.int32(1)
    sweeps = {
        "triton_onecall": engine._onecall_sweep_fn(tol),
        "xla_scan": engine._segment_sweep_fn(seg.make_exists_mask_kernel_xla(tol), False, True),
    }
    outs = {}
    for name, fn in sweeps.items():
        try:
            t0 = time.perf_counter()
            outs[name] = jax.block_until_ready(fn(rblob, cf, ci, cc, valid, min_sim))
            compile_s = time.perf_counter() - t0
            dt = timed(lambda: fn(rblob, cf, ci, cc, valid, min_sim), args.iters)
        except Exception as exc:  # noqa: BLE001 - recorded, the other route still runs
            res[f"stageA_{name}_error"] = repr(exc)[:300]
            log(f"stage A {name}: {exc!r}"[:400])
            continue
        ops = 2 * rb * seg.ROW_FRAMES * T * tile_f * 256
        res[f"stageA_{name}_ms_per_row_tile"] = dt * 1e3
        res[f"stageA_{name}_first_call_s"] = compile_s
        res[f"stageA_{name}_int8_tops"] = ops / dt / 1e12
        log(f"stage A {name}: {dt * 1e3:.3f} ms per row tile x {T} column tiles "
            f"({ops / dt / 1e12:.1f} int8 TOP/s of the main product; first call {compile_s:.1f} s)")
    if len(outs) == 2:
        same = all(
            np.array_equal(np.asarray(x), np.asarray(y))
            for x, y in zip(outs["triton_onecall"], outs["xla_scan"])
        )
        res["stageA_outputs_equal"] = same
        assert same, "Triton and XLA stage-A sweeps disagree"

    # HLO of the XLA twin's sweep: which GEMM implementation does the int8
    # product get, and do layouts force transposes?
    hlo = sweeps["xla_scan"].lower(rblob, cf, ci, cc, valid, min_sim).compile().as_text()
    if args.hlo_out:
        Path(args.hlo_out).write_text(hlo)
    targets = re.findall(r'custom_call_target="([^"]+)"', hlo)
    res["stageA_xla_custom_calls"] = {t: targets.count(t) for t in sorted(set(targets))}
    res["stageA_xla_transposes"] = len(re.findall(r"\btranspose\(", hlo))
    res["stageA_xla_fusion_kinds"] = {
        k: len(re.findall(rf"kind=k{k}\b", hlo)) for k in ("Loop", "Input", "Output", "Custom")
    }
    log(f"stage A XLA twin HLO: custom calls {res['stageA_xla_custom_calls']}, "
        f"transposes {res['stageA_xla_transposes']}, fusions {res['stageA_xla_fusion_kinds']}")
    del cf, outs

    # --- the same comparison end to end: the engine's pruned search over a
    # scene-profile library, stage A on Triton vs on the XLA twin ---------
    from hydrus_video_deduplicator_tpu.parallel.engine import TpuSearchEngine
    from tests.scene_library import scene_library

    lib = scene_library(args.e2e_videos, seed=0).blobs
    hits = {}
    for kind in ("triton", "xla"):
        eng = TpuSearchEngine(force_segments=True, exists_kernel=kind)
        eng.find_pairs_pruned(lib, lib, 50)  # compile + warm
        t0 = time.perf_counter()
        hits[kind] = sorted(eng.find_pairs_pruned(lib, lib, 50))
        dt = time.perf_counter() - t0
        res[f"pruned_search_{kind}_s_{args.e2e_videos}_videos"] = dt
        log(f"pruned search, {args.e2e_videos} videos x themselves, stage A on {kind}: {dt:.3f} s")
    res["pruned_search_equal"] = hits["triton"] == hits["xla"]
    assert res["pruned_search_equal"], "pruned search differs between Triton and XLA stage A"
    del lib, hits

    # --- unpruned segment route: score program per row tile --------------
    Ts = min(T, 16)
    cf_s = seg.unpack_blocks_pm1_stacked(c_packed[:Ts], ci[:Ts])
    score = engine._segment_sweep_fn(seg.similarity_segments_xla, False, False)
    dt = timed(lambda: score(rblob, cf_s, ci[:Ts], cc[:Ts], valid[:Ts], jnp.int32(50)), args.iters)
    res["score_xla_ms_per_row_tile_x16_tiles"] = dt * 1e3
    log(f"score program (XLA): {dt * 1e3:.3f} ms per row tile x {Ts} column tiles")
    del cf_s, c_packed

    # --- PDQ hash at the device batch ------------------------------------
    batch = device.capabilities().hash_batch
    frames = jax.random.randint(jax.random.PRNGKey(2), (batch, 512, 512, 3), 0, 256, jnp.uint8)
    dt = timed(lambda: mpdq.pdq_hash_batch_jit(frames), args.iters)
    res["pdq_xla_ms_per_batch"] = dt * 1e3
    res["pdq_xla_frames_per_s"] = batch / dt
    host_frames = np.asarray(frames)
    dt_h2d = timed(lambda: jax.device_put(host_frames), max(3, args.iters // 2))
    res["h2d_ms_per_batch"] = dt_h2d * 1e3
    res["h2d_gb_per_s"] = host_frames.nbytes / dt_h2d / 1e9
    log(f"PDQ XLA: {dt * 1e3:.3f} ms per {batch}-frame batch ({batch / dt:.0f} frames/s); "
        f"host->device copy {dt_h2d * 1e3:.3f} ms per batch ({res['h2d_gb_per_s']:.1f} GB/s)")
    del frames, host_frames

    # --- reference rates of this card ------------------------------------
    n = 8192
    x8 = jax.random.randint(jax.random.PRNGKey(3), (n, n), -127, 127, jnp.int8)
    mm8 = jax.jit(lambda p, q: jax.lax.dot_general(p, q, (((1,), (0,)), ((), ())), preferred_element_type=jnp.int32))
    dt = timed(lambda: mm8(x8, x8), args.iters)
    res["ref_int8_matmul_tops"] = 2 * n**3 / dt / 1e12
    xb = x8.astype(jnp.bfloat16)
    mmb = jax.jit(lambda p, q: p @ q)
    dt = timed(lambda: mmb(xb, xb), args.iters)
    res["ref_bf16_matmul_tflops"] = 2 * n**3 / dt / 1e12
    big = jnp.ones((1 << 30,), jnp.float32)
    cp = jax.jit(lambda z: z * 2)
    dt = timed(lambda: cp(big), args.iters)
    res["ref_copy_gb_per_s"] = 2 * big.nbytes / dt / 1e9
    log(f"reference: int8 matmul {res['ref_int8_matmul_tops']:.0f} TOP/s, bf16 "
        f"{res['ref_bf16_matmul_tflops']:.0f} TFLOP/s, copy {res['ref_copy_gb_per_s']:.0f} GB/s")

    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
