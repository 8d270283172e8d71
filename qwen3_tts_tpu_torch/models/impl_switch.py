"""The per-call implementation switches of the decode step
(``QWEN3_TTS_TALKER``, models/talker.py), the code predictor
(``QWEN3_TTS_CODEPRED``, models/code_predictor.py), the vocoder's
decoder blocks (``set_res_chain_impl``, models/vocoder.py) and decode
attention (``set_decode_attention_impl``, ops/attention.py); the last two
have no environment variable, as in the JAX package.

Each reads one of its values (``auto``, the default, ``fused`` and
``xla``, unless it names its own) from its environment variable, where it
has one, at every call, unless ``set`` overrides it; an unknown value
reads as ``auto``. The JAX package's ``*_interpret`` values (Pallas
interpret mode) have no counterpart and raise ``ValueError``: the kernel's
value on CPU tensors runs its torch twin.
"""

from __future__ import annotations

import os

IMPLS = ("auto", "fused", "xla")


class ImplSwitch:
    def __init__(self, env: str | None, name: str | None = None,
                 impls: tuple[str, ...] = IMPLS):
        self.env = env
        self.name = name or env
        self.impls = impls
        self.kernel = impls[1]       # the value that names the kernel
        self.impl: str | None = None

    def _check(self, impl) -> None:
        if impl == f"{self.kernel}_interpret":
            raise ValueError(f"{self.name}={impl} is not ported: use "
                             f"'{self.kernel}', which runs the kernel's "
                             f"torch twin on CPU tensors")
        if impl is not None and impl not in self.impls:
            raise ValueError(f"impl must be one of {(None, *self.impls)}")

    def set(self, impl: str | None) -> None:
        """Select the implementation for every later call (None: the
        environment variable again, or ``auto`` where there is none)."""
        self._check(impl)
        self.impl = impl

    def resolve(self) -> str:
        if self.impl is not None:
            return self.impl
        impl = os.environ.get(self.env, "auto") if self.env else "auto"
        if impl == f"{self.kernel}_interpret":
            self._check(impl)
        return impl if impl in self.impls else "auto"
