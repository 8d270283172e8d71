"""The architecture seam (benchmark/archs/).

Pins: the counts of both configurations and, at tiny widths on the CPU,
the weight bits of a seed and the reference's outputs, as literal values
read before the Qwen3-TTS code moved into benchmark/archs/: a move that
changes a count, a weight leaf or a reference output fails here.

Seam: a new architecture enters as new files only, the check goes
through the architecture's own reference, and an architecture without
its file is refused by name."""

import filecmp
import hashlib
import json

import numpy as np
import pytest
import torch

from benchmark import run as bench_run
from benchmark import spec
from benchmark.reference.layers import Prec
from benchmark.tests.tiny import (LIMITS, REPO, load_model, make_root,
                                  tiny_config, use_arch)

COUNTS = {
    "qwen3-tts-12hz-0.6b": {
        "talker_step": (176443883520, 3952082944),
        "codepred_frame": (496332963840, 226948096),
        "vocoder_chunk": (37701896110080.0, 241395140),
        "prefill_flops": 9368010752.0,
        "frame_flops": (8381493248.0, 8381722624.0)},
    "qwen3-tts-12hz-1.7b": {
        "talker_step": (549703385088, 5897949184),
        "codepred_frame": (509217865728, 237831168),
        "vocoder_chunk": (37701896110080.0, 241395140),
        "prefill_flops": 28932341760.0,
        "frame_flops": (10392662016.0, 10392891392.0)},
}

SEED = 2**31 + 5
WEIGHTS = {False: (192, "0224131d45bf7db8176abac7384553b2"),
           True: (192, "8d2373f2ba3891148c06e42970516bb2")}
REFERENCE = {
    (False, "f32"): (6, "ee412f245c25acb6e9b3e5596d130eb6"),
    (False, "fp8"): (6, "560b1de1eb54151cc4eec3018cb63699"),
    (True, "f32"): (6, "aea92409b01ef686a4a22f8817eafc42"),
    (True, "fp8"): (6, "b828612c5826c93b927b7cb71290b765")}


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree, key=str):
            yield from _leaves(tree[k], path + (str(k),))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    else:
        yield "/".join(path), tree


def _digest(tree) -> tuple:
    """(leaves, sha256 over each leaf's path, dtype, shape and bits)."""
    h, n = hashlib.sha256(), 0
    for path, t in _leaves(tree):
        h.update(path.encode())
        if t is not None:
            h.update(f"{t.dtype}{tuple(t.shape)}".encode())
            h.update(t.detach().contiguous().view(torch.uint8).numpy()
                     .tobytes())
        n += 1
    return n, h.hexdigest()[:32]


@pytest.fixture
def one_thread():
    """CPU products sum in an order that depends on the thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", sorted(COUNTS))
def test_counts_pinned(name):
    arch, m = load_model(name)
    P = m.prefill_len
    got = {"talker_step": arch.talker_step(m, 192, P + 128),
           "codepred_frame": arch.codepred_frame(m, 192),
           "vocoder_chunk": arch.vocoder_chunk(m, 192),
           "prefill_flops": arch.prefill_flops(m, 40, P),
           "frame_flops": (arch.frame_flops(m, 0), arch.frame_flops(m, 1))}
    assert got == COUNTS[name]


@pytest.mark.parametrize("mtp", [False, True], ids=["0.6b-shape",
                                                    "mtp-shape"])
def test_weights_and_reference_pinned(one_thread, mtp):
    arch, m = load_model(tiny_config(mtp))
    w = arch.make_weights(m, SEED, "cpu")
    assert _digest({"talker": w.talker, "vocoder": w.vocoder,
                    "voices": w.voices}) == WEIGHTS[mtp]
    g = np.random.default_rng(7)
    tokens = [400, 402, 403] + g.integers(0, 400, 14).tolist() + [
        401, 403, 400, 402, 403]
    codes = torch.as_tensor(g.integers(0, 256, (12, 16)))
    codes[:, 0] = torch.as_tensor(g.integers(0, 2048, 12))
    with torch.no_grad():
        for mode in ("f32", "fp8"):
            p = Prec(mode)
            seq, P = arch.talker_sequence(p, w.talker, m, tokens,
                                          w.voices[3], codes)
            h = arch.talker_hidden(p, w.talker, m, [seq, seq[:P + 3]])
            hh = h[0][P - 1:P - 1 + codes.shape[0]]
            out = {"seq": seq, "hidden": h,
                   "scores": arch.cb0_scores(p, w.talker, m, hh, codes,
                                             len(tokens), 1.05),
                   "logits": arch.code_logits(p, w.talker, m, hh, codes),
                   "audio": arch.vocode(p, w.vocoder, m.vocoder,
                                        codes[None].expand(2, -1, -1))}
            assert _digest(out) == REFERENCE[mtp, mode], {
                k: _digest(v) for k, v in out.items()}


TWIN = "from benchmark.archs.qwen3_tts_12hz import *  # noqa: F401,F403\n"

# The twin's reference alone reads the codec head negated: only the
# talker's number, cb0_gap, can move.
TWIN_NEGATED_HEAD = TWIN + """
import benchmark.archs.qwen3_tts_12hz as base


def cb0_scores(p, w, m, hidden, codes, n_tokens, penalty):
    w = dict(w, codec_head=-w["codec_head"])
    return base.cb0_scores(p, w, m, hidden, codes, n_tokens, penalty)
"""


def _files(folder):
    return {p.relative_to(folder) for p in folder.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def _run_offline(root, capsys):
    rc = bench_run.main(["--workload", "tiny-offline", "--seed",
                         str(2**31 + 77), "--seconds", "1"],
                        root=root, device="cpu")
    return rc, json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_new_arch_is_new_files_only(tmp_path, capsys):
    root = make_root(tmp_path)
    use_arch(root, "twin", TWIN)
    assert spec.load_cell("tiny-offline", root).arch.__file__ == str(
        root / "benchmark/archs/twin.py")
    rc, line = _run_offline(root, capsys)
    assert rc == 0 and line["correct"] is True, line["checks"]
    repo = {f for f in _files(REPO) if f.parts[0] == "benchmark"
            and "tests" not in f.parts}
    for f in sorted(repo):
        assert filecmp.cmp(REPO / f, root / f, shallow=False), f
    assert sorted(str(f) for f in _files(root) - repo) == [
        "BENCHMARK.json", "benchmark/archs/twin.py",
        "benchmark/configs/tiny.json", "benchmark/limits/tiny.json",
        "benchmark/traffic/tiny-offline.json",
        "benchmark/traffic/tiny-serve.json"]


def test_check_goes_through_the_arch_reference(tmp_path, capsys):
    root = make_root(tmp_path)
    use_arch(root, "twin", TWIN_NEGATED_HEAD)
    rc, line = _run_offline(root, capsys)
    checks = line["checks"]
    assert rc == 0 and line["correct"] is False, checks
    assert checks["cb0_gap"]["value"] > LIMITS["cb0_gap"]
    for n in ("code_gap", "pcm_err"):
        assert checks[n]["value"] <= LIMITS[n]


def test_unknown_arch_is_refused_by_name(tmp_path):
    root = make_root(tmp_path)
    use_arch(root, "nope")
    with pytest.raises(FileNotFoundError, match="benchmark/archs/nope.py"):
        spec.load_cell("tiny-offline", root)
