"""The offline model pipeline on the port alone (run with ``python -m``):
``convert_checkpoints`` (HF checkpoint -> GGUF), ``setup_models`` (the
model directory), ``parity`` (per-stage parity against an independent
HF-layout torch reference) and ``acceptance`` (the whole sequence). They
import torch, numpy and this package: no JAX, no ``safetensors`` and no
``ml_dtypes``."""
