"""A new configuration, traffic mix and per-layer metric are picked up
from new files and new entries alone: no file already in the checkout
changes."""

import hashlib
import json

from benchmark import run as bench_run
from benchmark.tests.tiny import LIMITS, OFFLINE, make_root, tiny_config

METRIC = '''"""Mean frames a request served in the window."""


def read(run):
    f = [s.n_frames for s in run.window_streams() if s.ok]
    return sum(f) / len(f) if f else None
'''


def _digests(root):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_files_only(tmp_path, capsys):
    root = make_root(tmp_path)
    before = _digests(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = tiny_config()
    cfg["name"] = "tiny-deep"
    cfg["talker_config"]["num_hidden_layers"] = 3
    (root / "benchmark/configs/tiny-deep.json").write_text(json.dumps(cfg))
    (root / "benchmark/limits/tiny-deep.json").write_text(json.dumps(LIMITS))
    (root / "benchmark/traffic/tiny-pairs.json").write_text(
        json.dumps(dict(OFFLINE, batch=2)))
    (root / "benchmark/metrics/frames_per_request.py").write_text(METRIC)
    bench["configs"].append({"name": "tiny-deep", "source": "test",
                             "file": "benchmark/configs/tiny-deep.json",
                             "reduced": [], "why": "three layers"})
    bench["workloads"].append({"name": "tiny-deep-pairs",
                               "config": "tiny-deep",
                               "traffic": "tiny-pairs", "chips": 1,
                               "why": "pairs"})
    bench["per_layer"].append({
        "name": "frames_per_request", "unit": "frames", "better": "higher",
        "source": "program_counter", "layer": "serving",
        "moves": "audio_s_per_s", "workloads": ["tiny-deep-pairs"]})
    bench_json = json.dumps(bench)
    for trace in (0, 1):
        (root / "BENCHMARK.json").write_text(bench_json)
        rc = bench_run.main(["--workload", "tiny-deep-pairs", "--seed", "9",
                             "--seconds", "1", "--trace", str(trace)],
                            root=root, device="cpu")
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert rc == 0 and line["correct"] is True
        assert line["attempted"] % 2 == 0
        if trace:
            assert 0 < line["metrics"]["frames_per_request"]["value"] <= 60
        else:
            assert set(line["metrics"]) == {"audio_s_per_s", "setup_s"}
    after = _digests(root)
    changed = [p for p, d in before.items()
               if p.name != "BENCHMARK.json" and after.get(p) != d]
    assert changed == []
    old = json.loads(json.dumps(bench))
    for key in ("configs", "workloads", "per_layer"):
        old[key] = old[key][:-1]
    assert json.loads((root / "BENCHMARK.json").read_text())[
        "workloads"][:-1] == old["workloads"]
