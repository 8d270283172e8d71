"""The per-call implementation switches of the decode step
(``QWEN3_TTS_TALKER``, models/talker.py) and the code predictor
(``QWEN3_TTS_CODEPRED``, models/code_predictor.py).

Each reads ``auto`` (the default), ``fused`` or ``xla`` from its
environment variable at every call, unless ``set`` overrides it; an
unknown value reads as ``auto``. The JAX package's ``fused_interpret``
(Pallas interpret mode) has no counterpart and raises ``ValueError``:
``fused`` on CPU tensors runs the kernel's torch twin.
"""

from __future__ import annotations

import os

IMPLS = ("auto", "fused", "xla")


class ImplSwitch:
    def __init__(self, env: str):
        self.env = env
        self.impl: str | None = None

    def _check(self, impl) -> None:
        if impl == "fused_interpret":
            raise ValueError(f"{self.env}=fused_interpret is not ported: use "
                             f"'fused', which runs the kernel's torch twin "
                             f"on CPU tensors")
        if impl is not None and impl not in IMPLS:
            raise ValueError(f"impl must be one of {(None, *IMPLS)}")

    def set(self, impl: str | None) -> None:
        """Select the implementation for every later call (None: read the
        environment variable again)."""
        self._check(impl)
        self.impl = impl

    def resolve(self) -> str:
        if self.impl is not None:
            return self.impl
        impl = os.environ.get(self.env, "auto")
        if impl == "fused_interpret":
            self._check(impl)
        return impl if impl in IMPLS else "auto"
