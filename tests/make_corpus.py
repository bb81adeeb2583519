"""Generate the committed test corpus (synthetic stand-in for the reference's
testdb submodule, which is not vendored — SURVEY.md §2 row 15).

Layout mirrors the reference's testdb:
  tests/corpus/videos/scene_a/S01_*   — similarity group 1 (same scene,
                                        different encodings/resolutions)
  tests/corpus/videos/scene_b/S02_*   — similarity group 2
  tests/corpus/videos/strange/*       — degenerate inputs that must hash
                                        without crashing (not similarity-checked)
  tests/corpus/hashes/<name>.txt      — golden VPDQ hashes (hex) from the
                                        native oracle

Videos with the same SXX_ prefix must be mutually similar (>= 75); videos
from different groups must not be. Run with --overwrite to regenerate.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).parents[1]))

CORPUS = Path(__file__).parent / "corpus"
VIDEOS = CORPUS / "videos"
HASHES = CORPUS / "hashes"


def smooth_noise(rng: np.random.Generator, h: int, w: int, octaves=3) -> np.ndarray:
    """Textured grayscale-ish RGB pattern with enough gradient for PDQ quality."""
    img = np.zeros((h, w, 3), dtype=np.float64)
    for o in range(octaves):
        sh, sw = max(2, h >> (octaves - o)), max(2, w >> (octaves - o))
        layer = rng.random((sh, sw, 3))
        ri = (np.arange(h) * sh // h), (np.arange(w) * sw // w)
        up = layer[ri[0]][:, ri[1]]
        img += up * (0.6**o)
    img -= img.min()
    img /= max(img.max(), 1e-9)
    return (img * 255).astype(np.uint8)


def scene_frames(seed: int, n_frames: int, h: int, w: int) -> list[np.ndarray]:
    """A deterministic 'scene': textured background with motion + drift."""
    rng = np.random.default_rng(seed)
    base = smooth_noise(rng, h, w)
    sprite = smooth_noise(rng, max(1, min(h // 4, h)), max(1, min(w // 4, w)))
    frames = []
    for i in range(n_frames):
        f = np.roll(base, (i * h) // (3 * max(n_frames, 1)), axis=1).astype(np.int32)
        # moving bright sprite
        sy = (i * (h - sprite.shape[0])) // max(n_frames - 1, 1)
        sx = ((n_frames - 1 - i) * (w - sprite.shape[1])) // max(n_frames - 1, 1)
        f[sy : sy + sprite.shape[0], sx : sx + sprite.shape[1]] //= 2
        f[sy : sy + sprite.shape[0], sx : sx + sprite.shape[1]] += sprite.astype(np.int32) // 2
        frames.append(np.clip(f, 0, 255).astype(np.uint8))
    return frames


# --------------------------------------------------------------------------
# Writers
# --------------------------------------------------------------------------


def write_y4m(path: Path, frames: list[np.ndarray], fps_num=5, fps_den=1) -> None:
    """C444 full-range y4m (lossless RGB->YUV444 would still quantize; we use
    an exact-roundtrip trick: store Y=G, U=B+128-ish? No — store real BT.601
    with the same fixed-point math the decoder inverts approximately; minor
    loss is fine, hashes are committed post-encode)."""
    h, w = frames[0].shape[:2]
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{w} H{h} F{fps_num}:{fps_den} Ip A1:1 C444\n".encode())
        for fr in frames:
            r = fr[:, :, 0].astype(np.int32)
            g = fr[:, :, 1].astype(np.int32)
            b = fr[:, :, 2].astype(np.int32)
            y = (299 * r + 587 * g + 114 * b + 500) // 1000
            u = ((-169 * r - 331 * g + 500 * b) + 500 * 255) // 1000 // 1 + 0
            u = np.clip(((b - y) * 564 + 500) // 1000 + 128, 0, 255)
            v = np.clip(((r - y) * 713 + 500) // 1000 + 128, 0, 255)
            y = np.clip(y, 0, 255)
            f.write(b"FRAME\n")
            f.write(y.astype(np.uint8).tobytes())
            f.write(u.astype(np.uint8).tobytes())
            f.write(v.astype(np.uint8).tobytes())


def write_gif(path: Path, frames: list[np.ndarray], fps=5) -> None:
    from PIL import Image

    imgs = [Image.fromarray(f) for f in frames]
    imgs[0].save(
        path,
        save_all=True,
        append_images=imgs[1:],
        duration=int(round(1000 / fps)),
        loop=0,
    )


def write_apng(path: Path, frames: list[np.ndarray], fps=5) -> None:
    """Animated PNG — a first-class input for the reference tool
    ("system:filetype=video, gif, apng", reference dedup.py:199-203)."""
    from PIL import Image

    imgs = [Image.fromarray(f) for f in frames]
    imgs[0].save(
        path,
        format="PNG",
        save_all=True,
        append_images=imgs[1:],
        duration=int(round(1000 / fps)),
        loop=0,
    )


def write_avi_mjpg(path: Path, frames: list[np.ndarray], fps=5) -> bool:
    import cv2

    h, w = frames[0].shape[:2]
    writer = cv2.VideoWriter(
        str(path), cv2.VideoWriter_fourcc(*"MJPG"), fps, (w, h), isColor=True
    )
    if not writer.isOpened():
        return False
    for f in frames:
        writer.write(f[:, :, ::-1])  # RGB -> BGR
    writer.release()
    return True


def write_native(path: Path, codec: str, frames: list[np.ndarray], fps=5, pts_ms=None,
                 gop_size=0, max_b_frames=-1) -> None:
    """Real inter-frame codecs (h264, vp9, mpeg4) via the native libav
    encoder — the reference's testdb uses real codec media (Big Buck Bunny /
    Sintel h264); the synthetic corpus must exercise the same decode path."""
    from hydrus_video_deduplicator_tpu.native import decode as nd

    nd.encode_video(path, codec, frames, fps, 1, pts_ms=pts_ms,
                    gop_size=gop_size, max_b_frames=max_b_frames)


def resize(frames: list[np.ndarray], h: int, w: int) -> list[np.ndarray]:
    out = []
    for f in frames:
        ri = ((2 * np.arange(h) + 1) * f.shape[0]) // (2 * h)
        ci = ((2 * np.arange(w) + 1) * f.shape[1]) // (2 * w)
        out.append(np.ascontiguousarray(f[ri][:, ci]))
    return out


#: real photographs shipped with Apache-2.0 / MIT packages in this image —
#: real image statistics for the "real footage" groups (the reference's
#: testdb uses Big Buck Bunny / Sintel footage, not fetchable here)
REAL_PHOTOS = [
    "/opt/venv/lib/python3.12/site-packages/dm_control/locomotion/arenas/"
    "assets/outdoor_natural/OutdoorSkybox2048.png",
    "/opt/venv/lib/python3.12/site-packages/gymnasium_robotics/envs/assets/"
    "kitchen_franka/kitchen_assets/textures/wood1.png",
]


def ken_burns(photo_path: str, n_frames: int, h: int, w: int, seed: int) -> list[np.ndarray]:
    """Real-footage clip: slow pan+zoom over a real photograph (the same
    content model as camera footage of a static scene — consecutive frames
    differ by small, correlated changes)."""
    from PIL import Image

    img = np.asarray(Image.open(photo_path).convert("RGB"))
    ih, iw = img.shape[:2]
    rng = np.random.default_rng(seed)
    # crop window glides from one corner region to another while zooming
    z0, z1 = 0.55, 0.40  # crop fraction of the photo
    x0, y0 = rng.uniform(0, 0.1, 2)
    x1, y1 = rng.uniform(0.3, 0.5, 2)
    frames = []
    for t in range(n_frames):
        a = t / max(n_frames - 1, 1)
        z = z0 + (z1 - z0) * a
        ch, cw = int(ih * z), int(iw * z)
        oy = int((y0 + (y1 - y0) * a) * (ih - ch))
        ox = int((x0 + (x1 - x0) * a) * (iw - cw))
        crop = img[oy : oy + ch, ox : ox + cw]
        pil = Image.fromarray(crop).resize((w, h), Image.BILINEAR)
        frames.append(np.asarray(pil))
    return frames


def upscale(frames: list[np.ndarray], h: int, w: int) -> list[np.ndarray]:
    """Bilinear upscale (the resolution-ladder re-encodes; nearest-index
    resize() keeps hard pixel edges that no real upscaler produces)."""
    from PIL import Image

    return [
        np.asarray(Image.fromarray(f).resize((w, h), Image.BILINEAR))
        for f in frames
    ]


def rolling_shutter(frames: list[np.ndarray], max_skew_px=1) -> list[np.ndarray]:
    """Rolling-shutter skew: each row's exposure samples a slightly later
    scene, so horizontal motion shears the frame — top row unshifted,
    bottom row shifted by up to max_skew_px in the direction of motion
    (alternating sign over time like a panning camera). Edge-replicated
    like camera_degrade (wrap would introduce a hard discontinuity)."""
    out = []
    for t, f in enumerate(frames):
        h = f.shape[0]
        direction = 1 if (t // 4) % 2 == 0 else -1
        pad = np.pad(f, ((0, 0), (max_skew_px,) * 2, (0, 0)), mode="edge")
        g = np.empty_like(f)
        for r in range(h):
            dx = direction * int(round(max_skew_px * r / max(h - 1, 1)))
            g[r] = pad[r, max_skew_px - dx : max_skew_px - dx + f.shape[1]]
        out.append(g)
    return out


def exposure_drift(frames: list[np.ndarray], lo=0.90, hi=1.10) -> list[np.ndarray]:
    """Slow exposure ramp across the clip (auto-exposure hunting): gain
    glides lo -> hi. PDQ is luma-DCT-sign based, so a global gain should
    barely move the hash — this variant documents that robustness."""
    gains = np.linspace(lo, hi, max(len(frames), 1))
    return [
        np.clip(f.astype(np.float32) * g, 0, 255).astype(np.uint8)
        for f, g in zip(frames, gains)
    ]


def camera_degrade(
    frames: list[np.ndarray], seed: int, shake_px=2, blur_taps=3, noise_sigma=4.0
) -> list[np.ndarray]:
    """Camera-capture simulation of a clip: handheld shake (clamped
    random-walk crop jitter), motion blur (temporal mean over blur_taps
    neighbors — an open shutter along the motion path), independent
    per-frame Gaussian sensor noise, and mild exposure flicker. Encoded
    lossy h264 downstream, these must stay >= 75 similar to their group."""
    rng = np.random.default_rng(seed)
    off = np.clip(
        np.cumsum(rng.integers(-1, 2, (len(frames), 2)), axis=0),
        -shake_px,
        shake_px,
    )
    half = blur_taps // 2
    out = []
    for t, _f in enumerate(frames):
        taps = [
            frames[min(len(frames) - 1, max(0, t + d))].astype(np.float32)
            for d in range(-half, half + 1)
        ]
        acc = np.mean(taps, axis=0)
        # edge-replicated translation (np.roll would WRAP pixels across the
        # frame edge — a hard discontinuity no real camera produces, and it
        # alone drops PDQ similarity to ~62)
        dy, dx = int(off[t, 0]), int(off[t, 1])
        pad = np.pad(acc, ((shake_px,) * 2, (shake_px,) * 2, (0, 0)), mode="edge")
        acc = pad[
            shake_px - dy : shake_px - dy + acc.shape[0],
            shake_px - dx : shake_px - dx + acc.shape[1],
        ]
        gain = 1.0 + 0.03 * np.sin(t * 0.7)
        acc = acc * gain + rng.normal(0.0, noise_sigma, acc.shape)
        out.append(np.clip(acc, 0, 255).astype(np.uint8))
    return out


def build(overwrite: bool) -> None:
    for d in (
        VIDEOS / "scene_a",
        VIDEOS / "scene_b",
        VIDEOS / "scene_c",
        VIDEOS / "scene_d",
        VIDEOS / "strange",
        HASHES,
    ):
        d.mkdir(parents=True, exist_ok=True)

    fps = 5
    n = 40  # 8 sampled frames at 5 fps

    # Group S01
    a = scene_frames(101, n, 120, 160)
    write_y4m(VIDEOS / "scene_a" / "S01_master.y4m", a, fps)
    write_gif(VIDEOS / "scene_a" / "S01_gif.gif", a, fps)
    write_avi_mjpg(VIDEOS / "scene_a" / "S01_mjpg.avi", a, fps)
    write_y4m(VIDEOS / "scene_a" / "S01_small.y4m", resize(a, 72, 96), fps)
    write_native(VIDEOS / "scene_a" / "S01_h264.mp4", "libx264", a, fps)
    write_native(VIDEOS / "scene_a" / "S01_vp9.webm", "libvpx-vp9", a, fps)
    write_apng(VIDEOS / "scene_a" / "S01_apng.png", a, fps)

    # Group S02
    b = scene_frames(202, n, 120, 160)
    write_y4m(VIDEOS / "scene_b" / "S02_master.y4m", b, fps)
    write_gif(VIDEOS / "scene_b" / "S02_gif.gif", b, fps)
    write_avi_mjpg(VIDEOS / "scene_b" / "S02_mjpg.avi", b, fps)
    write_native(VIDEOS / "scene_b" / "S02_h264.mp4", "libx264", b, fps)
    write_native(VIDEOS / "scene_b" / "S02_mpeg4.avi", "mpeg4", b, fps)

    # scene_a extra encoding: long-GOP, B-frame-heavy h264 (decode must
    # handle reordered frames; round-3 corpus-breadth item)
    write_native(
        VIDEOS / "scene_a" / "S01_longgop.mp4", "libx264", a, fps,
        gop_size=250, max_b_frames=3,
    )

    # Groups S03/S04: REAL-FOOTAGE clips — pan+zoom camera motion over
    # real photographs (REAL_PHOTOS), in three codec variants including
    # long-GOP h264 and B-frame-heavy hevc
    c = ken_burns(REAL_PHOTOS[0], n, 120, 160, seed=3)
    write_y4m(VIDEOS / "scene_c" / "S03_master.y4m", c, fps)
    write_native(
        VIDEOS / "scene_c" / "S03_longgop264.mp4", "libx264", c, fps,
        gop_size=250, max_b_frames=3,
    )
    try:
        write_native(VIDEOS / "scene_c" / "S03_hevc.mp4", "libx265", c, fps)
    except Exception as exc:  # hevc encoder optional in the build env
        print(f"skipping hevc variant: {exc}")
    d4 = ken_burns(REAL_PHOTOS[1], n, 120, 160, seed=4)
    write_y4m(VIDEOS / "scene_d" / "S04_master.y4m", d4, fps)
    write_native(VIDEOS / "scene_d" / "S04_mpeg4.avi", "mpeg4", d4, fps)

    # camera-capture variants of the real-footage groups: motion blur +
    # sensor noise + flicker (+1px handheld shake for S03), lossy h264.
    # Tuned against PDQ's measured sensitivities: a 2px shake alone drops
    # similarity to 25-37 (texture DCT signs flip under shift), and the
    # wood texture of S04 is fragile enough that shake is omitted there
    # (tripod profile) — the matrix requires every in-group pair >= 75.
    write_native(
        VIDEOS / "scene_c" / "S03_camera.mp4", "libx264",
        camera_degrade(c, seed=31, shake_px=1, blur_taps=3, noise_sigma=3.0),
        fps,
    )
    write_native(
        VIDEOS / "scene_d" / "S04_camera.mp4", "libx264",
        camera_degrade(d4, seed=41, shake_px=0, blur_taps=3, noise_sigma=2.0),
        fps,
    )

    # Resolution ladder: multi-resolution re-encodes of
    # each group's content — the reference testdb's core matrix is the same
    # clip at several resolutions (test_vpdqpy.py:28-55 BBB/Sintel ladders).
    # S01/S02/S04 ladder by bilinear upscale of the master (what a
    # re-encoding pipeline does to stored media); S03 re-renders the
    # ken-burns path at the target resolution (true-detail ladder, the
    # closer analog of the same footage exported at two resolutions).
    write_native(VIDEOS / "scene_a" / "S01_360p.mp4", "libx264",
                 upscale(a, 360, 480), fps)
    write_native(VIDEOS / "scene_a" / "S01_720p.mp4", "libx264",
                 upscale(a, 720, 960), fps)
    write_native(VIDEOS / "scene_b" / "S02_480p.mp4", "libx264",
                 upscale(b, 480, 640), fps)
    c360 = ken_burns(REAL_PHOTOS[0], n, 360, 480, seed=3)
    write_native(VIDEOS / "scene_c" / "S03_360p.mp4", "libx264", c360, fps)
    c720 = ken_burns(REAL_PHOTOS[0], n, 720, 960, seed=3)
    write_native(VIDEOS / "scene_c" / "S03_720p.mp4", "libx264", c720, fps)
    write_native(VIDEOS / "scene_d" / "S04_480p.mp4", "libx264",
                 upscale(d4, 480, 640), fps)

    # harder camera realism: rolling-shutter skew (S03, 1 px — PDQ flips
    # DCT signs under larger shears on fine texture) and auto-exposure
    # drift (S01 synthetic + S04 wood texture)
    write_native(
        VIDEOS / "scene_c" / "S03_rollshutter.mp4", "libx264",
        rolling_shutter(c, max_skew_px=1), fps,
    )
    write_native(
        VIDEOS / "scene_a" / "S01_expdrift.mp4", "libx264",
        exposure_drift(a), fps,
    )
    write_native(
        VIDEOS / "scene_d" / "S04_expdrift.mp4", "libx264",
        exposure_drift(d4, lo=0.94, hi=1.06), fps,
    )

    # Strange corpus: must hash (possibly to empty) without crashing.
    strange = VIDEOS / "strange"
    one = scene_frames(303, 1, 64, 64)
    write_gif(strange / "one_frame.gif", one, fps=1)
    tiny = scene_frames(304, 6, 4, 4)
    write_y4m(strange / "tiny_4x4.y4m", tiny, 2)
    black = [np.zeros((32, 32, 3), np.uint8)] * 5
    write_y4m(strange / "all_black.y4m", black, 5)  # quality 0 -> empty hash
    thin = scene_frames(305, 8, 8, 256)
    write_y4m(strange / "thin_8x256.y4m", thin, 4)
    fast = scene_frames(306, 30, 48, 64)
    write_y4m(strange / "high_fps.y4m", fast, 30)  # 30 fps, 1 s -> 1 sampled frame
    mono_frames = scene_frames(307, 6, 40, 40)
    with open(strange / "mono.y4m", "wb") as f:
        f.write(b"YUV4MPEG2 W40 H40 F5:1 Cmono\n")
        for fr in mono_frames:
            f.write(b"FRAME\n")
            f.write(fr[:, :, 1].tobytes())
    # animated webp: the one format routed to Pillow even in auto decode
    # mode (libavcodec cannot decode webp animation — backends.py)
    anim_webp = scene_frames(309, 6, 48, 48)
    from PIL import Image

    webp_imgs = [Image.fromarray(f) for f in anim_webp]
    webp_imgs[0].save(
        strange / "anim.webp",
        save_all=True,
        append_images=webp_imgs[1:],
        duration=500,
        loop=0,
    )
    # rotated / letterboxed variants of scene_a (PDQ is not rotation- or
    # letterbox-invariant; these document that behavior — hashed, excluded
    # from similarity groups like the reference's strange/ set)
    rot = [np.rot90(f).copy() for f in a]
    write_y4m(strange / "rot90_scene_a.y4m", rot, fps)
    letter = []
    for f in a:
        lb = np.zeros((f.shape[0] + 60, f.shape[1], 3), np.uint8)
        lb[30:-30] = f
        letter.append(lb)
    write_y4m(strange / "letterbox_scene_a.y4m", letter, fps)

    # variable frame rate: no avg_frame_rate -> every frame hashed
    # (reference vpdqpy.py:73-77 None-fps branch, on a real container)
    vfr = scene_frames(308, 6, 64, 64)
    write_native(
        strange / "vfr_vp9.webm", "libvpx-vp9", vfr,
        pts_ms=[0, 120, 500, 900, 2000, 2400],
    )

    # Golden hashes from the native oracle.
    from hydrus_video_deduplicator_tpu.hashing import compute_phash

    for vid in sorted(VIDEOS.rglob("*")):
        if not vid.is_file():
            continue
        out = HASHES / f"{vid.name}.txt"
        if out.exists() and not overwrite:
            continue
        phash = compute_phash(vid)
        out.write_text(str(phash) + "\n")
        print(f"{vid.relative_to(CORPUS)}: {len(phash)} frames")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--overwrite", action="store_true")
    args = ap.parse_args()
    build(args.overwrite)
