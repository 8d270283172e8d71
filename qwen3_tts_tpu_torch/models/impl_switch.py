"""The per-call implementation switches of the decode step
(``QWEN3_TTS_TALKER``, models/talker.py), the code predictor
(``QWEN3_TTS_CODEPRED``, models/code_predictor.py) and the vocoder's
decoder blocks (``set_res_chain_impl``, models/vocoder.py, which has no
environment variable, as in the JAX package).

Each reads ``auto`` (the default), ``fused`` or ``xla`` from its
environment variable, where it has one, at every call, unless ``set``
overrides it; an unknown value reads as ``auto``. The JAX package's ``fused_interpret``
(Pallas interpret mode) has no counterpart and raises ``ValueError``:
``fused`` on CPU tensors runs the kernel's torch twin.
"""

from __future__ import annotations

import os

IMPLS = ("auto", "fused", "xla")


class ImplSwitch:
    def __init__(self, env: str | None, name: str | None = None):
        self.env = env
        self.name = name or env
        self.impl: str | None = None

    def _check(self, impl) -> None:
        if impl == "fused_interpret":
            raise ValueError(f"{self.name}=fused_interpret is not ported: use "
                             f"'fused', which runs the kernel's torch twin "
                             f"on CPU tensors")
        if impl is not None and impl not in IMPLS:
            raise ValueError(f"impl must be one of {(None, *IMPLS)}")

    def set(self, impl: str | None) -> None:
        """Select the implementation for every later call (None: the
        environment variable again, or ``auto`` where there is none)."""
        self._check(impl)
        self.impl = impl

    def resolve(self) -> str:
        if self.impl is not None:
            return self.impl
        impl = os.environ.get(self.env, "auto") if self.env else "auto"
        if impl == "fused_interpret":
            self._check(impl)
        return impl if impl in IMPLS else "auto"
