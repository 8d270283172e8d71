"""A run with the timed path broken underneath comes out not correct,
once for each fault a cell of this benchmark can have (every cell is on
one card, so there is no exchange between chips to leave out): a token
altered where it is produced, a talker step that returns its state
unchanged, half of the batch left out."""

import json

import pytest
import torch

from benchmark import run as bench_run
from benchmark.tests.tiny import make_root


def _token_altered(monkeypatch):
    from qwen3_tts_tpu_torch.models import code_predictor
    real = code_predictor.sample_codes

    def altered(logits, *a, **k):
        return (real(logits, *a, **k) + 1) % logits.shape[-1]
    monkeypatch.setattr(code_predictor, "sample_codes", altered)


def _step_unchanged(monkeypatch):
    from qwen3_tts_tpu_torch.models import talker

    def unchanged(w, cfg, step_embd, kv_cache, *a, **k):
        h, logits = talker._head(w, cfg, step_embd)
        return step_embd.float(), logits, kv_cache
    monkeypatch.setattr(talker, "talker_step", unchanged)


def _half_batch(monkeypatch):
    from qwen3_tts_tpu_torch.models import code_predictor
    real = code_predictor.predict_codes

    def half(w, cfg, hidden, *a, **k):
        out = real(w, cfg, hidden, *a, **k)
        out[hidden.shape[0] // 2:] = 0
        return out
    monkeypatch.setattr(code_predictor, "predict_codes", half)


@pytest.mark.parametrize("cell", ["tiny-offline", "tiny-serve"])
@pytest.mark.parametrize("fault", [None, _token_altered, _step_unchanged,
                                   _half_batch])
def test_fault_is_not_correct(tmp_path, capsys, monkeypatch, fault, cell):
    root = make_root(tmp_path)
    torch.manual_seed(0)
    if fault is not None:
        fault(monkeypatch)
    rc = bench_run.main(["--workload", cell, "--seed", "424242",
                         "--seconds", "1"], root=root, device="cpu")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0
    assert line["correct"] is (fault is None), line["checks"]
