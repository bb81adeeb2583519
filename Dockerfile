# Hydrus video deduplicator with a JAX device path.
# CPU image by default (native C++ hasher); build with
#   --build-arg EXTRAS=cuda  on an NVIDIA GPU host for the device compute
# path (JAX's CUDA 12 install, jax[cuda12]).

FROM python:3.12-slim AS base

ARG EXTRAS=""

# FFmpeg dev libraries power the native reference-exact decode path
# (native/decode.cpp); libgl/glib are OpenCV runtime deps for the fallback.
RUN apt-get update \
    && apt-get install -y --no-install-recommends g++ make pkg-config \
        libgl1 libglib2.0-0 \
        libavformat-dev libavcodec-dev libswscale-dev libavutil-dev \
    && rm -rf /var/lib/apt/lists/*

WORKDIR /app
COPY . /app

RUN pip install --no-cache-dir ".${EXTRAS:+[$EXTRAS]}" \
    && make -C hydrus_video_deduplicator_tpu/native \
    && make -C hydrus_video_deduplicator_tpu/native decode

ENTRYPOINT ["/app/docker-entrypoint.sh"]
