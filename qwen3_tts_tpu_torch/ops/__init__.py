from .layers import (gqa_attention_prefill, gqa_attention_step,
                     gqa_attention_step_masked, rms_norm, rope_neox, swiglu)

__all__ = [
    "rms_norm",
    "rope_neox",
    "swiglu",
    "gqa_attention_prefill",
    "gqa_attention_step",
    "gqa_attention_step_masked",
]
