"""The port's analysis pass (``repro_torch.analysis``): each FLT rule
against its committed bad/clean fixture pair under
``tests/fixtures/analysis_torch/`` at the expected lines, suppression
comments, the port linting clean with zero suppressions in
``src/repro_torch/core`` (each one elsewhere giving its reason on its
line), the CLI's exit codes and JSON report; the contract matrix's
4-config diagonal (every engine, topology, codec and DP value) on a
one-rank gloo group, and a planted fault for each check: a host sync, DP
after the encode and a missing or spurious normal draw, an all-reduce on a
group the topology did not declare, a wrong wire dtype, an f64 tensor, a
stream that reads its metrics back; the launch sentinel clean on a stable
round and catching a round whose launches change.

The whole 16-config matrix runs in ``python -m repro_torch.analysis``
(about 10 s); the reference's own test of its collective check fails on
this JAX, so the port's check is held to its own planted negative."""
import json
import os
import re

import pytest
import torch
import torch.distributed as dist

from repro_torch import random as rnd
from repro_torch.analysis import contracts, launches, lint
from repro_torch.analysis.__main__ import main as analysis_main
from repro_torch.comm import codecs as codecs_lib
from repro_torch.core import rounds

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "analysis_torch")

# rule -> the lines its bad fixture is flagged at
EXPECTED_LINES = {"FLT001": [9, 10, 11, 12], "FLT002": [9, 12, 13, 14],
                  "FLT003": [10, 11, 12], "FLT004": [2, 3, 7, 7],
                  "FLT005": [7, 8, 9, 10], "FLT006": [5, 10, 11]}


def _lint_fixture(name):
    return lint.lint_paths([os.path.join(FIXTURES, name)], root=REPO)


@pytest.mark.parametrize("code", sorted(EXPECTED_LINES))
def test_rule_flags_bad_fixture_at_expected_lines(code):
    res = _lint_fixture(f"{code.lower()}_bad.py")
    assert res.exit_code == 1
    assert {f.code for f in res.findings} == {code}
    assert sorted(f.line for f in res.findings) == EXPECTED_LINES[code], \
        [f.render() for f in res.findings]


@pytest.mark.parametrize("code", sorted(EXPECTED_LINES))
def test_rule_passes_clean_twin(code):
    res = _lint_fixture(f"{code.lower()}_clean.py")
    assert res.exit_code == 0, [f.render() for f in res.findings]


def test_flt002_names_each_pattern():
    msgs = " ".join(f.message for f in _lint_fixture("flt002_bad.py").findings)
    for part in ("already consumed", "fold_in the loop index", "client_keys",
                 "global generator"):
        assert part in msgs


def test_suppression_comment(tmp_path):
    bad = open(os.path.join(FIXTURES, "flt001_bad.py")).read()
    patched = bad.replace(".item()             #",
                          ".item()  # flint: disable=FLT001 (a planted reason) #")
    p = tmp_path / "suppressed.py"
    p.write_text(patched)
    res = lint.lint_paths([p], root=tmp_path)
    assert all(f.line != 9 for f in res.findings)
    assert [(s.line, s.code, s.suppressed) for s in res.suppressed] == [(9, "FLT001", True)]
    # a suppression names its code: another rule's code does not hide it
    p.write_text(bad.replace(".item()             #", ".item()  # flint: disable=FLT003 #"))
    assert any(f.line == 9 for f in lint.lint_paths([p], root=tmp_path).findings)


def test_suppression_without_code_disables_all(tmp_path):
    p = tmp_path / "all_off.py"
    p.write_text(
        "import time\n"
        "from repro_torch.core import rounds\n"
        "def step(s, inp):\n"
        "    return s * time.time(), {}  # flint: disable\n"
        "def run(s, inputs):\n"
        "    return rounds.loop_rounds(step, s, inputs)\n")
    res = lint.lint_paths([p], root=tmp_path)
    assert res.exit_code == 0 and len(res.suppressed) == 1


def test_port_is_lint_clean_with_zero_core_suppressions():
    res = lint.lint_paths([os.path.join(REPO, "src", "repro_torch")], root=REPO)
    assert res.exit_code == 0, "\n".join(f.render() for f in res.findings)
    core = os.path.join("src", "repro_torch", "core")
    assert not [s for s in res.suppressed if core in s.path]
    for s in res.suppressed:
        line = open(s.path).read().splitlines()[s.line - 1]
        assert re.search(r"flint: disable=\w+ \(.+\)", line), (
            f"{s.path}:{s.line}: a suppression gives its reason on its line")


def test_roots_and_host_boundaries(tmp_path):
    """A step factory's returned closure, an autograd Function's backward
    and a run_rounds step are roots; a thread target and a sink are not."""
    p = tmp_path / "roots.py"
    p.write_text(
        "import threading, time\n"
        "import torch\n"
        "def make_train_step(model):\n"
        "    def train_step(s):\n"
        "        return s.item()\n"
        "    return train_step\n"
        "class F(torch.autograd.Function):\n"
        "    @staticmethod\n"
        "    def backward(ctx, g):\n"
        "        return g.cpu()\n"
        "def drain():\n"
        "    return time.time()\n"
        "def host():\n"
        "    threading.Thread(target=drain).start()\n")
    res = lint.lint_paths([p], root=tmp_path)
    assert sorted((f.line, f.code) for f in res.findings) == [(5, "FLT001"), (10, "FLT001")]


def test_cli_exit_codes_per_fixture():
    for code in EXPECTED_LINES:
        assert analysis_main([os.path.join(FIXTURES, f"{code.lower()}_bad.py")]) == 1
        assert analysis_main([os.path.join(FIXTURES, f"{code.lower()}_clean.py")]) == 0


def test_cli_json_report(tmp_path):
    out = tmp_path / "report.json"
    rc = analysis_main([os.path.join(FIXTURES, "flt004_bad.py"), "--format", "json",
                        "-o", str(out)])
    assert rc == 1
    report = json.loads(out.read_text())
    assert report["tool"] == "repro_torch.analysis"
    assert report["lint"]["num_findings"] == 4
    assert all(f["code"] == "FLT004" for f in report["lint"]["findings"])
    # explicit paths skip the contracts and the sentinel
    assert report["contracts"] is None and report["launches"] is None


# ---------------------------------------------------------------------------
# the contracts
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def group():
    """A one-rank gloo group for the sharded configs, gone after the
    module."""
    started = not dist.is_initialized()
    yield
    if started and dist.is_initialized():
        dist.destroy_process_group()


def test_diagonal_covers_every_value():
    diag = contracts.diagonal_configs()
    assert len(contracts.matrix_configs()) == 16 and len(diag) == 4
    for axis in range(1, 5):
        assert {c[axis] for c in diag} == {c[axis] for c in contracts.matrix_configs()}


@pytest.mark.parametrize("cfg", contracts.diagonal_configs(), ids=lambda c: c[0])
def test_contract_config_passes(cfg, group):
    assert contracts.run_config(*cfg) == []


def test_recorder_sees_launches_and_the_topology_group(group):
    """The sharded int8 + DP round: its dp_noise launches come before its
    keyed quantize launches, its collectives run on the topology's group,
    and the plain versions' ops are seen inside the wrappers."""
    data, params0, fl = contracts.problem()
    ev = []
    orig = contracts.record_round

    def keep(*a, **k):
        state, rec = orig(*a, **k)
        ev.extend(rec.events)
        return state, rec

    contracts.record_round = keep
    try:
        assert contracts.run_config("dense/sharded/int8/dp", "dense", "sharded",
                                    "int8", True) == []
    finally:
        contracts.record_round = orig
    names = [e.name for e in ev if e.kind == "launch"]
    assert "dp_noise" in names and "stochastic_quantize_keyed" in names
    assert names.index("dp_noise") < names.index("stochastic_quantize_keyed")
    assert {e.group for e in ev if e.group is not None} == {dist.group.WORLD.group_name}
    assert any(e.inside and e.name == "erfinv" for e in ev)


def test_host_sync_is_caught(group):
    bad = contracts.run_config("dense/local/identity/nodp", "dense", "local",
                               "identity", False,
                               plant=lambda topo: torch.ones(2).sum().item())
    assert [v.check for v in bad] == ["no_host_sync"]


def test_undeclared_collective_is_caught(group):
    """An all-reduce on a group the sharded topology did not declare, and
    any collective in a local round."""
    other = dist.new_group([0])
    bad = contracts.run_config("dense/sharded/identity/nodp", "dense", "sharded",
                               "identity", False,
                               plant=lambda topo: dist.all_reduce(torch.ones(2), group=other))
    assert [v.check for v in bad] == ["collectives"]
    assert repr(other.group_name) in bad[0].detail
    bad = contracts.run_config("dense/local/identity/nodp", "dense", "local",
                               "identity", False,
                               plant=lambda topo: dist.all_reduce(torch.ones(2)))
    assert [v.check for v in bad] == ["collectives"]


def _ev(*items):
    return [contracts.Event("launch", n) if k == "L" else
            contracts.Event("op", n, d) for k, n, d in items]


def test_dp_before_encode_catches_swapped_order():
    swapped = _ev(("L", "stochastic_quantize_keyed", ()), ("L", "dp_noise", ()))
    assert "does not precede" in contracts.check_dp_before_encode(swapped, True, True)[0]
    ops = _ev(("L", "dp_noise", ()), ("O", "_to_copy", (torch.int8,)),
              ("O", "erfinv", (torch.float32,)), ("L", "stochastic_quantize_keyed", ()))
    assert "erfinv" in contracts.check_dp_before_encode(ops, True, True)[0]
    good = _ev(("L", "dp_noise", ()), ("O", "erfinv", (torch.float32,)),
               ("L", "stochastic_quantize_keyed", ()), ("O", "_to_copy", (torch.int8,)))
    assert contracts.check_dp_before_encode(good, True, True) == []


def test_dp_before_encode_catches_missing_and_spurious_noise():
    assert contracts.check_dp_before_encode(
        _ev(("L", "stochastic_quantize_keyed", ())), True, True)
    assert contracts.check_dp_before_encode(
        _ev(("O", "erfinv", (torch.float32,))), False, False)
    assert contracts.check_dp_before_encode(_ev(("L", "dp_noise", ())), True, True)


def test_wire_dtypes_catches_spec_violation():
    wrong = codecs_lib.QuantEncoded(values=torch.zeros(4, dtype=torch.int16),
                                    scales=torch.zeros(1, dtype=torch.float64))
    bad = contracts.check_wire_dtypes(wrong, "int8")
    assert len(bad) == 2 and "int16" in bad[0] and "float64" in bad[1]
    for name in ("identity", "int8", "topk", "topk8"):
        enc = contracts.encoded(codecs_lib.make_codec(name), 300)
        assert contracts.check_wire_dtypes(enc, name) == [], name


def test_f64_is_caught(group):
    bad = contracts.run_config("dense/local/identity/nodp", "dense", "local",
                               "identity", False,
                               plant=lambda topo: torch.ones(2, dtype=torch.float64) * 2)
    assert [v.check for v in bad] == ["no_f64"]


def test_obs_contract_and_a_stream_that_syncs(monkeypatch):
    assert contracts.check_obs("cpu") == []
    from repro_torch.obs import metrics
    orig = metrics._stage

    def syncing(tensors, dtype):
        float(tensors[0].reshape(-1)[0])
        return orig(tensors, dtype)

    monkeypatch.setattr(metrics, "_stage", syncing)
    assert any("host sync" in d for d in contracts.check_obs("cpu"))


# ---------------------------------------------------------------------------
# the launch sentinel
# ---------------------------------------------------------------------------


def test_launch_sentinel_clean_on_stable_rounds():
    for name, counts, violations in launches.run(num_rounds=4):
        assert violations == [], name
        assert counts["kernels"]["ssca_update"] == 1
        assert counts["kernels"].get("stochastic_quantize_keyed", 0) == (name == "int8")


def test_launch_sentinel_catches_a_changing_round():
    from repro_torch.kernels.ssca_update import ssca_update_

    def step(state, inp):
        w, buf, g = state
        if int(inp.t[0]) == 4:                    # an extra launch in round 4
            ssca_update_(w, buf, g, 0.5, 0.5, 0.2, 0.0)
        ssca_update_(w, buf, g, inp.rho[0], inp.gamma[0], 0.2, 0.0)
        return state, {"w": w.sum()}

    state = (torch.zeros(8), torch.zeros(8), torch.ones(8))
    inputs = rounds.make_inputs(contracts.FLConfig(), 1, 5, rnd.PRNGKey(0, device="cpu"))
    inputs = type(inputs)(*(x[:, None] if x.dim() == 1 else x[:, None] for x in inputs))
    _, counts = launches.round_counts(step, state, inputs)
    bad = launches.check(counts)
    assert [v.round for v in bad] == [4]
    assert bad[0].kernels == {"ssca_update": (1, 2)}
    assert launches.check(counts[:3]) == []
