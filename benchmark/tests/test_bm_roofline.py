"""Operation and byte counts checked by hand at one shape per layer."""

import json

import pytest

from benchmark import roofline
from benchmark.tests.tiny import load_model, tiny_config


def test_talker_step_06b():
    arch, m = load_model("qwen3-tts-12hz-0.6b")
    # per layer: qkv 1024x4096 + wo 2048x1024 + gate|up|down 3x1024x3072
    assert roofline.layer_matrix_params(m.talker) == 15_728_640
    assert arch.talker_step(m, 1, 0) == (
        2 * 28 * 15_728_640 + 28 * 4 * 16 * 128 + 2 * 1024 * 3072,
        2 * (28 * 15_728_640 + 1024 * 3072) + 4 * (28 * 2304 + 1024)
        + 28 * 2 * 8 * 128 * 2 + 4 * (1024 + 1024 + 3072))
    flops, nbytes = arch.talker_step(m, 2, 9)
    assert flops == 1_778_778_112
    assert nbytes == 889_692_160


def test_codepred_frame_17b_with_mtp():
    arch, m = load_model("qwen3-tts-12hz-1.7b")
    assert m.has_mtp and m.talker.hidden == 2048
    flops, nbytes = arch.codepred_frame(m, 1)
    # 16 positions x 5 layers, attention over 1..16 keys, 15 heads, and
    # the 2048 -> 1024 projection of the 16 inputs
    assert flops == (2_516_582_400 + 5_570_560 + 62_914_560
                     + 67_108_864)
    assert nbytes == 224_395_264 + 54_272 + 61_440 + 8_256
    _, m06 = load_model("qwen3-tts-12hz-0.6b")
    assert arch.codepred_frame(m06, 1)[0] == flops - 67_108_864


def test_vocoder_tiny_by_hand():
    _, m = load_model(tiny_config())
    assert roofline.vocoder_flops_per_stream(m, 2) == 717_312
    assert m.vocoder.samples_per_frame == 64


def test_share_and_bound():
    assert roofline.bound_s(989e12, 0) == pytest.approx(1.0)
    assert roofline.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert roofline.share_pct(989e9, 0, 0.002) == pytest.approx(50.0)


def test_frame_flops_linear_in_position():
    arch, m = load_model("qwen3-tts-12hz-0.6b")
    a, b, c = (arch.frame_flops(m, n) for n in (0, 1, 100))
    assert c - a == pytest.approx(100 * (b - a))
    # ~8.6 GFLOP a stream frame: talker 0.89, code predictor 2.6, vocoder
    assert 8e9 < a < 9.5e9
    json.dumps(a)
