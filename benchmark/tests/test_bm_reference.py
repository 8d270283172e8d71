"""The reference against the program's own path at tiny widths on the
CPU (a test only: the runs never compare with the program's internals):
the talker's prefill and decode through the cache, the code predictor
(with the mtp projection), and the vocoder's causal chunk decode."""

import numpy as np
import pytest
import torch

from benchmark import program
from benchmark.reference.layers import Prec
from benchmark.tests.tiny import load_model, tiny_config


@pytest.fixture(params=[False, True], ids=["0.6b-shape", "mtp-shape"])
def tiny(request):
    arch, m = load_model(tiny_config(mtp=request.param))
    return arch, m, arch.make_weights(m, 5, "cpu")


def test_talker_and_code_predictor(tiny):
    from qwen3_tts_tpu_torch.models import code_predictor, talker
    from qwen3_tts_tpu_torch.runtime.generate import (generate_frame,
                                                      init_state,
                                                      make_consts)
    arch, m, w = tiny
    assert m.has_mtp == (w.talker["code_pred"]["mtp_w"] is not None)
    cfg = arch.talker_config(m)
    g = np.random.default_rng(0)
    tokens = [400, 402, 403] + g.integers(0, 400, 12).tolist() + [
        401, 403, 400, 402, 403]
    spk = w.voices[1]
    with torch.no_grad():
        pf = talker.build_prefill_inputs(
            w.talker, cfg, torch.tensor([tokens], dtype=torch.int32),
            torch.tensor([len(tokens)]), spk[None])
        state = init_state(w.talker, cfg, pf, 128, torch.Generator()
                           .manual_seed(1))
        consts = make_consts(pf, 0.9, 1.05)
        h_prog, codes = [], []
        for _ in range(30):
            h_prog.append(state.last_hidden[0].clone())
            c, _ = generate_frame(w.talker, cfg, state, consts, 50)
            codes.append(c[0])
        codes = torch.stack(codes)
        seq, P = arch.talker_sequence(Prec(), w.talker, m, tokens, spk,
                                      codes)
        h_ref = arch.talker_hidden(Prec(), w.talker, m, [seq])[0]
        h_ref = h_ref[P - 1:]
        h_prog = torch.stack(h_prog)
        err = (h_prog - h_ref).norm(dim=-1) / h_ref.norm(dim=-1)
        assert err.max() < 0.03
        # the code predictor, greedy on the reference's talker state, and
        # the reference teacher-forced on the codes it chose
        out = torch.zeros(15, 30, m.cp_vocab)
        rest = code_predictor.predict_codes(
            w.talker, cfg, h_ref, codes[:, 0], 0.9, 50, greedy=True,
            logits_out=out)
        want = arch.code_logits(Prec(), w.talker, m, h_ref,
                                torch.cat([codes[:, :1], rest], dim=1))
    rel = ((out.transpose(0, 1) - want).abs().amax(-1)
           / want.abs().amax(-1))
    assert rel.max() < 0.03


def test_vocoder_chunk(tiny):
    from qwen3_tts_tpu_torch.models import vocoder
    arch, m, w = tiny
    vcfg = program.vocoder_config(m.vocoder)
    codes = torch.randint(0, 2048, (2, 40, 16),
                          generator=torch.Generator().manual_seed(3))
    codes[1, 25:] = 0                      # a zero-padded tail
    with torch.no_grad():
        got = vocoder.vocoder_decode(w.vocoder, vcfg, codes, trim="causal")
        want = arch.vocode(Prec(), w.vocoder, m.vocoder, codes)
    assert got.shape == want.shape == (2, 40 * m.vocoder.samples_per_frame)
    assert float((got - want).norm() / want.norm()) < 1e-4
