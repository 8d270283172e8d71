"""The port's tools (run with ``python -m``). The offline model pipeline:
``convert_checkpoints`` (HF checkpoint -> GGUF), ``setup_models`` (the
model directory), ``parity`` (per-stage parity against an independent
HF-layout torch reference) and ``acceptance`` (the whole sequence). The
measurement programs: ``bench`` (lock-step throughput and its B ladder),
``bench_serve`` (continuous batching: throughput, time to first audio,
queue wait) and ``bench_breakdown`` (a frame's time by stage), sharing
``bench_common``. They import torch, numpy and this package: no JAX, no
``safetensors`` and no ``ml_dtypes``."""
