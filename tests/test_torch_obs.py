"""The port's observability and checkpoints against the reference's on the
CPU: the sinks' output and the run manifest's keys, ``MetricStream``'s rows
(their order, thinning and values) beside ``repro.obs``'s for the same
driver run, phase labels and profiles, and ``checkpoint/msgpack_ckpt``'s
bytes, which equal ``msgpack.packb(..., use_bin_type=True)`` and load in the
reference's ``load_checkpoint`` (and the reference's files in the port's),
for fp32 MLP params and nested bf16 smoke params.

Tolerances: rows carry the same keys in the same order; round values within
1e-5 (the trajectories' standard), the round numbers and kinds equal;
checkpoint bytes equal, loaded tensors bit-equal.
"""
import io
import json
import os

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro.checkpoint import msgpack_ckpt as jckpt
from repro.configs.base import FLConfig as JFLConfig
from repro.configs.registry import ARCHS as JARCHS
from repro.core import algorithms as jalg
from repro.core import fed as jfed
from repro.core import topology as jtopo
from repro.data.synthetic import classification_dataset as jdataset
from repro.models import mlp as jmlp
from repro.models import transformer as jtr
from repro.obs import metrics as jmetrics
from repro.obs import sinks as jsinks
from repro_torch import convert
from repro_torch.checkpoint import msgpack_ckpt as tckpt
from repro_torch.configs.base import FLConfig
from repro_torch.core import algorithms as talg
from repro_torch.core import privacy as tpriv
from repro_torch.core import topology as ttopo
from repro_torch.launch import train as ttrain
from repro_torch.models import mlp as tmlp
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import sinks as tsinks
from repro_torch.obs import trace as ttrace

P, J, L, I, B, N = 32, 16, 10, 4, 20, 400
FL_KW = dict(num_clients=I, batch_size=B, a1=0.3, a2=0.3, alpha_rho=0.1,
             alpha_gamma=0.6, tau=0.05, l2_lambda=1e-5)
ROWS = [{"loss": 1.5, "t": 1, "kind": "round"},
        {"kind": "eval", "t": 1, "acc": 0.25, "cost": 2.0},
        {"kind": "span", "span": "dispatch", "dur_s": 0.125, "rounds": 3},
        {"loss": 1.25, "upload_bytes": 4096.0, "kind": "round", "t": 2}]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The suite runs in several processes at once: two PyTorch threads a
    process keep them from oversubscribing the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)

@pytest.fixture(scope="module")
def setup():
    (z, y, _), _ = jdataset(jax.random.PRNGKey(0), n=N, num_features=P,
                            num_classes=L, test_n=50, noise=4.0)
    jd = jfed.partition_samples(z, y, I)
    p0 = {k: np.asarray(v) for k, v in jmlp.init(jax.random.PRNGKey(1), P, J,
                                                 L).items()}
    return {"jd": jd, "p0": p0, "z": np.asarray(z), "y": np.asarray(y),
            "td": convert.sample_fed_data_from_numpy(
                *(np.asarray(a) for a in jd), device="cpu")}


# ---------------------------------------------------------------------------
# sinks and the manifest
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sink", ["JsonlSink", "CsvSink"])
def test_file_sinks_write_the_reference_bytes(tmp_path, sink):
    out = {}
    for name, mod in (("jax", jsinks), ("torch", tsinks)):
        path = str(tmp_path / name / f"rows.{sink}")
        s = getattr(mod, sink)(path)
        for row in ROWS:
            s.emit(dict(row))
        getattr(s, "flush", lambda: None)()
        s.close()
        out[name] = open(path).read()
    assert out["torch"] == out["jax"] and out["torch"]


def test_stdout_and_memory_sinks_match(capsys):
    for mod in (jsinks, tsinks):
        s = mod.StdoutSink(prefix="run")
        for row in ROWS:
            s.emit(row)
        s.close()
    lines = capsys.readouterr().out.splitlines()
    assert lines[:len(ROWS)] == lines[len(ROWS):] and len(lines) == 2 * len(ROWS)
    mj, mt = jsinks.MemorySink(), tsinks.MemorySink()
    for row in ROWS:
        mj.emit(row)
        mt.emit(row)
    assert mt.rows == mj.rows


def test_jsonable_converts_tensors_and_configs():
    row = {"x": torch.tensor(2.5), "n": np.float32(1.5), "cfg": FLConfig(),
           "tup": (1, 2)}
    got = tsinks._jsonable(row)
    assert got["x"] == 2.5 and got["n"] == 1.5 and got["tup"] == [1, 2]
    assert got["cfg"] == jsinks._jsonable(JFLConfig())


def test_manifest_keys_and_values(tmp_path):
    dpt = tpriv.DPConfig(epsilon=4.0)
    from repro.core import privacy as jpriv
    cfg = {"arch": "qwen2.5-3b", "steps": 3}
    jm = jsinks.run_manifest(cfg, codec="int8", topology=jtopo.LOCAL,
                             extra={"dp": jpriv.manifest_info(
                                 jpriv.DPConfig(epsilon=4.0), 1.0, rounds=3)})
    tm = tsinks.write_manifest(str(tmp_path / "m.json"), cfg, codec="int8",
                               topology=ttopo.LOCAL, device="cpu",
                               extra={"dp": tpriv.manifest_info(dpt, 1.0,
                                                                rounds=3)})
    assert set(jm) <= set(tm)
    for k in ("config", "codec", "topology", "git_sha"):
        assert tm[k] == jm[k], k
    assert tm["dp"] == pytest.approx(jm["dp"], rel=1e-12)
    assert tm["backend"] == "cpu" and tm["jax_version"] is None
    assert json.load(open(tmp_path / "m.json")) == tm
    tsinks.bench_json(str(tmp_path / "b.json"), {"a": torch.tensor(1.0)},
                      manifest=tm)
    assert json.load(open(tmp_path / "b.json")) == {"a": 1.0}
    assert os.path.exists(tmp_path / "b.json.manifest.json")


# ---------------------------------------------------------------------------
# MetricStream
# ---------------------------------------------------------------------------


def _alg1(pkg, setup, obs, rounds=7, eval_every=3):
    if pkg == "jax":
        def jeval(params, state):
            return {"cost": jmlp.mean_loss(params, setup["z"], setup["y"])}
        return jalg.algorithm1(jmlp.per_sample_loss,
                               jax.tree.map(jnp.asarray, setup["p0"]),
                               setup["jd"], JFLConfig(**FL_KW), rounds,
                               jax.random.PRNGKey(2), eval_fn=jeval,
                               eval_every=eval_every, obs=obs)
    tz, ty = torch.tensor(setup["z"]), torch.tensor(setup["y"])

    def teval(params, state):
        return {"cost": tmlp.mean_loss(params, tz, ty)}
    return talg.algorithm1(tmlp.per_sample_loss,
                           convert.params_from_numpy(setup["p0"], "cpu"),
                           setup["td"], FLConfig(**FL_KW), rounds,
                           convert.key_from_numpy(np.asarray(
                               jax.random.PRNGKey(2)), "cpu"),
                           eval_fn=teval, eval_every=eval_every, obs=obs,
                           device="cpu")


@pytest.mark.parametrize("log_every,flush_every", [(1, 200), (2, 2)])
def test_stream_rows_match_the_reference(setup, log_every, flush_every):
    """A driver run streamed through both packages' MetricStreams: the same
    rows in the same order (round rows of the log_every cadence, each chunk
    followed by its eval row), with the same keys and values within 1e-5;
    the run's history equals the unobserved run's bit for bit."""
    js = jmetrics.MetricStream([jsinks.MemorySink()], log_every=log_every,
                               flush_every=flush_every)
    ts = tmetrics.MetricStream([tsinks.MemorySink()], log_every=log_every,
                               flush_every=flush_every)
    _alg1("jax", setup, js)
    rt = _alg1("torch", setup, ts)
    js.close()
    ts.close()
    jr, tr = js.sinks[0].rows, ts.sinks[0].rows
    assert [(r["kind"], r["t"]) for r in tr] == [(r["kind"], r["t"]) for r in jr]
    assert [list(r) for r in tr] == [list(r) for r in jr]
    assert ts.rows == tr
    for a, b in zip(tr, jr):
        for k in b:
            if k not in ("kind", "t"):
                assert isinstance(a[k], float)
                assert a[k] == pytest.approx(b[k], abs=1e-5, rel=1e-5), k
    bare = _alg1("torch", setup, None)
    for k in bare.history:
        assert torch.equal(bare.history[k], rt.history[k]), k
    for k in bare.params:
        assert torch.equal(bare.params[k], rt.params[k])


def test_stream_events_keep_dispatch_order():
    s = tmetrics.MetricStream([tsinks.MemorySink()])
    s.emit_event({"kind": "eval", "t": 0, "v": 1.0})
    s.emit_event({"kind": "eval", "t": 1, "v": torch.tensor(2.5)})
    s.emit_event({"kind": "span", "span": "x", "dur_s": 0.5})
    s.close()
    assert [r["t"] if "t" in r else r["span"] for r in s.sinks[0].rows] == \
        [0, 1, "x"]
    assert s.sinks[0].rows[1]["v"] == 2.5 and isinstance(s.rows[1]["v"], float)


def test_host_spans_rows(setup):
    s = tmetrics.MetricStream([tsinks.MemorySink()])
    spans = ttrace.HostSpans(s)
    with spans.span("dispatch", rounds=3, t0=1):
        pass
    s.close()
    row = s.sinks[0].rows[0]
    assert list(row) == ["kind", "span", "dur_s", "rounds", "t0"]
    assert row["kind"] == "span" and row["dur_s"] >= 0 and spans.spans == [row]


def test_phase_is_free_until_profiled_and_profile_holds_the_phases(
        setup, tmp_path):
    assert ttrace.phase("round") is ttrace.phase("aggregate")   # shared no-op
    assert set(ttrace.PHASES) >= {"round", "client-compute", "codec-encode",
                                  "aggregate"}
    with ttrace.profile(str(tmp_path / "prof")):
        assert not isinstance(ttrace.phase("round"), type(ttrace._NULL))
        _alg1("torch", setup, None, rounds=2, eval_every=0)
    text = open(tmp_path / "prof" / "trace.json").read()
    for name in ("round", "client-compute", "aggregate", "batch-select"):
        assert f'"{name}"' in text, name


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _smoke_bf16():
    jp = jtr.init(jax.random.PRNGKey(0), JARCHS["qwen2.5-3b"].smoke())
    jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
    tp = jax.tree.map(lambda a: torch.from_numpy(
        np.asarray(a).view(np.uint16).astype(np.int32)).to(torch.int16).view(
            torch.bfloat16), jp)
    return jp, tp


def _mlp(setup):
    return (jax.tree.map(jnp.asarray, setup["p0"]),
            convert.params_from_numpy(setup["p0"], "cpu"))


@pytest.mark.parametrize("kind", ["mlp_fp32", "smoke_bf16"])
def test_checkpoint_bytes_and_cross_loads(setup, tmp_path, kind):
    jp, tp = _mlp(setup) if kind == "mlp_fp32" else _smoke_bf16()
    jpath, tpath = str(tmp_path / "j.msgpack"), str(tmp_path / "t.msgpack")
    jckpt.save_checkpoint(jpath, jp, step=17)
    tckpt.save_checkpoint(tpath, tp, step=17)
    raw = open(tpath, "rb").read()
    assert raw == open(jpath, "rb").read()
    assert raw == msgpack.packb(msgpack.unpackb(raw, raw=False),
                                use_bin_type=True)
    back, step = jckpt.load_checkpoint(tpath, jp)
    assert step == 17
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        assert a.dtype == b.dtype and np.array_equal(
            np.asarray(a).view(np.uint8), np.asarray(b).view(np.uint8))
    like = jax.tree.map(lambda t: torch.zeros_like(t), tp)
    tback, step = tckpt.load_checkpoint(jpath, like)
    assert step == 17
    for a, b in zip(tckpt._flatten(tback), tckpt._flatten(tp)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("tree", [
    {"b1": 0, "w1": 0}, {"w1": 0, "b1": {"a": 0, "c": [0, 0]}, "z": (0,)},
    {"x": None, "y": 0}, 0, [], {}, {"layers": {"attn": {"wq": 0}}, "emb": 0}])
def test_treedef_string_is_jax_s(tree):
    tt = jax.tree.map(lambda _: torch.zeros(1), tree)
    assert tckpt.treedef_str(tt) == str(jax.tree.structure(tree))


def test_msgpack_subset_matches_packb():
    for obj in (None, True, 0, 127, 128, 65536, 2**40, -1, -33, -200,
                -70000, -2**40, 1.25, "", "x" * 40, "é" * 300, b"",
                b"\x00" * 300, [1] * 20, {"k": [1, {"m": b"ab"}]},
                {str(i): i for i in range(20)}):
        data = tckpt.packb(obj)
        assert data == msgpack.packb(obj, use_bin_type=True), obj
        back = tckpt.unpack(io.BytesIO(data))
        assert back == msgpack.unpackb(data, raw=False)


def test_checkpoint_refuses_mismatches(setup, tmp_path):
    _, tp = _mlp(setup)
    path = str(tmp_path / "c.msgpack")
    tckpt.save_checkpoint(path, tp, step=1)
    like64 = {k: v.double() for k, v in tp.items()}
    with pytest.raises(ValueError, match="dtype mismatch"):
        tckpt.load_checkpoint(path, like64)
    back, _ = tckpt.load_checkpoint(path, like64, cast=True)
    assert all(back[k].dtype == torch.float64 for k in back)
    assert all(torch.equal(back[k].float(), tp[k]) for k in tp)
    with pytest.raises(ValueError, match="treedef"):
        tckpt.load_checkpoint(path, {"a": tp["w0"], "b": tp["w1"]})
    with pytest.raises(ValueError, match="leaves"):
        tckpt.load_checkpoint(path, {"w0": tp["w0"]})


# ---------------------------------------------------------------------------
# the train loop's observability
# ---------------------------------------------------------------------------


def test_train_loop_streams_profiles_and_checkpoints(tmp_path, capsys):
    log = str(tmp_path / "run.jsonl")
    ckpt = str(tmp_path / "params.msgpack")
    dp = tpriv.DPConfig(epsilon=8.0, clip_norm=1.0)
    state, logs = ttrain.train_loop(
        "qwen2.5-3b", 2, 2, 8, smoke=True, log_every=1, device="cpu",
        codec="int8", dp=dp, log_jsonl=log, profile_dir=str(tmp_path / "prof"),
        ckpt_path=ckpt)
    rows = [json.loads(ln) for ln in open(log)]
    rounds = [r for r in rows if r["kind"] == "round"]
    assert [r["t"] for r in rounds] == [1, 2]
    assert {"loss", "t", "upload_bytes", "dp_epsilon", "dp_clip_frac",
            "dp_noise_norm", "kind"} == set(rounds[0])
    assert [r["span"] for r in rows if r["kind"] == "span"] == ["dispatch"] * 2
    man = json.load(open(log + ".manifest.json"))
    assert man["codec"] == "int8" and man["dp"]["rounds"] == 2
    assert man["topology"] == {"name": "local", "num_shards": 1}
    assert os.path.exists(tmp_path / "prof" / "trace.json")
    params = ttrain.unwrap_comm(state).params
    back, step = tckpt.load_checkpoint(ckpt, params)
    assert step == 2
    for a, b in zip(tckpt._flatten(back), tckpt._flatten(params)):
        assert torch.equal(a, b)
    assert logs[-1]["dp_epsilon"] == pytest.approx(rounds[-1]["dp_epsilon"])
