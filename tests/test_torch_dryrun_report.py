"""repro_torch's ``launch/perf.py`` and ``launch/report.py``.

* ``perf.parse_val`` equals the reference's on the same strings (one
  reference subprocess: importing ``repro.launch.perf`` sets the 512-device
  ``XLA_FLAGS``, which must not reach this process);
* ``perf.main`` re-traces one cell with ``--set`` overrides under its tag,
  recording the overrides, and refuses a ``reduce_*`` key as
  ``make_step_config`` does;
* ``report.py`` renders the §Roofline and §Dry-run tables from a port
  JSON written by the dry-run's own command line, in the reference's
  columns with the fit column named for the card, and shows a refused
  cell's reason.
"""

import json

import pytest

from conftest import run_distributed
from repro_torch.launch import dryrun, perf, report

VALUES = ["true", "True", "false", "False", "0", "17", "-3", "1e3", "2.5",
          "bfloat16", "psum", "", "1_000", "nan", "inf", "0x10", "None"]

JAX_SCRIPT = r"""
import json
from repro.launch.perf import parse_val
print("PARSE " + json.dumps([[type(v).__name__, repr(v)]
                             for v in map(parse_val, {values!r})]))
"""


def test_parse_val_equals_the_reference():
    out = run_distributed(JAX_SCRIPT.format(values=VALUES), n_devices=1)
    line = next(l for l in out.splitlines() if l.startswith("PARSE "))
    want = json.loads(line[len("PARSE "):])
    got = [[type(v).__name__, repr(v)] for v in map(perf.parse_val, VALUES)]
    assert got == want


@pytest.fixture(scope="module")
def port_json(tmp_path_factory):
    path = tmp_path_factory.mktemp("dryrun") / "dryrun_torch.json"
    dryrun.main(["--arch", "llama3.2-1b", "--shape", "train_4k,decode_32k",
                 "--mesh", "single", "--out", str(path)])
    cache = json.loads(path.read_text())
    cache["baseline|whisper-base|decode_32k|single"] = {
        "refused": "whisper-base: a cache of 32768 slots would be "
                   "sequence-sharded", "tag": "baseline",
        "arch": "whisper-base", "shape": "decode_32k"}
    path.write_text(json.dumps(cache))
    return path


def test_dryrun_records_have_the_reference_keys(port_json):
    cache = json.loads(port_json.read_text())
    cells = [v for v in cache.values() if "roofline" in v]
    assert len(cells) == 2
    for rec in cells:
        for key in ("memory", "roofline", "collectives", "params",
                    "active_params", "kernels"):
            assert key in rec, key
        assert rec["devices"] == 256 and rec["mesh"] == "16x16"
        assert set(rec["memory"]) >= {"peak_gb", "fits", "state_gb",
                                      "batch_gb"}
        assert rec["roofline"]["t_compute_s"] > 0
    train = next(v for v in cells if v["shape"] == "train_4k")
    assert {"comm_plan", "schedule"} <= set(train)
    assert train["kernels"]["reduce_add"] > 0


def test_report_renders_both_tables(port_json, capsys):
    report.main([str(port_json)])
    text = capsys.readouterr().out
    assert "### Roofline (single-pod 16x16, per device)" in text
    assert "### Dry-run records (both meshes)" in text
    assert "| fits H100 80GB |" in text and "| peak GB |" in text
    rows = [l for l in text.splitlines() if l.startswith("| llama3.2-1b |")]
    # train_4k and decode_32k in each table, prefill_32k pending, and
    # long_500k skipped (full attention)
    assert len(rows) == 2 + 4
    assert any("pending" in r and "prefill_32k" in r for r in rows)
    assert any("skipped" in r and "long_500k" in r for r in rows)
    assert "refused: whisper-base: a cache of 32768 slots" in text


def test_perf_retraces_one_cell_with_overrides(tmp_path, capsys):
    out = tmp_path / "dryrun_torch.json"
    perf.main(["--arch", "llama3.2-1b", "--shape", "train_4k", "--tag",
               "arena_ch1", "--set", "use_arena=true", "--set",
               "comm_channels=1", "--set", "comm_page_bytes=4096", "--out",
               str(out)])
    cache = json.loads(out.read_text())
    rec = cache["arena_ch1|llama3.2-1b|train_4k|single"]
    assert rec["overrides"] == {"use_arena": "True", "comm_channels": "1",
                                "comm_page_bytes": "4096"}
    assert rec["comm_plan"]["n_channels"] == 1
    assert rec["comm_plan"]["arena"]["page_bytes"] == 4096
    # the arena's write and read on every segment, the ring's adds
    assert rec["kernels"]["pack.write"] == rec["kernels"]["pack.read"] > 0
    assert rec["kernels"]["reduce_add"] > 0
    assert "[arena_ch1] llama3.2-1bxtrain_4k" in capsys.readouterr().out
    with pytest.raises(ValueError, match="reduce_"):
        perf.main(["--arch", "llama3.2-1b", "--shape", "train_4k", "--tag",
                   "x", "--set", "reduce_policy=psum", "--out", str(out)])
