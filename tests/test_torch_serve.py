"""Port parity for the serving path: the scheduler's batch formation
(``form_batches``), ``Server.admit``, ``Server.kv_trace`` and the greedy
outputs of ``Server.serve`` (``repro_torch.launch.serve``, on the CPU)
against ``repro.launch.serve`` on the same requests and float32 params."""

import dataclasses
import inspect

import jax
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core.config import SchedulerConfig as JSched
from repro.core.scheduler import form_batches as jform_batches
from repro.launch import serve as jserve
from repro.models import build_lm as jbuild_lm
from repro_torch import convert
from repro_torch.core.config import SchedulerConfig as TSched
from repro_torch.core.scheduler import form_batches as tform_batches
from repro_torch.core.scheduler import form_batches_seq
from repro_torch.launch import serve as tserve
from repro_torch.models import build_lm as tbuild_lm


def _batches(former, sched, addrs, rw, arrival):
    return [(b.rw, b.addr.tolist(), b.seq.tolist(), b.pe_id.tolist(),
             b.size.tolist())
            for b in former(addrs, rw, arrival, config=sched)]


@settings(max_examples=60, deadline=None, derandomize=True)
@given(n=st.integers(0, 80),
       batch_pow=st.integers(2, 6),
       timeout=st.integers(4, 40),
       seed=st.integers(0, 2 ** 16),
       saturated=st.booleans())
def test_form_batches_matches_reference(n, batch_pow, timeout, seed,
                                        saturated):
    rng = np.random.default_rng(seed)
    addrs = rng.integers(0, 1000, n)
    rw = (rng.random(n) < 0.3).astype(np.int32)
    arrival = None if saturated else np.cumsum(rng.integers(0, 12, n))
    kw = dict(batch_size=2 ** batch_pow, timeout_cycles=timeout)
    want = _batches(jform_batches, JSched(**kw), addrs, rw, arrival)
    assert _batches(tform_batches, TSched(**kw), addrs, rw, arrival) == want
    assert _batches(form_batches_seq, TSched(**kw), addrs, rw, arrival) == want


def _requests(n=12, prompt_len=8, new_tokens=4, vocab=256, seed=0,
              gap=3, ragged=False):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        s = prompt_len - (i % 3 if ragged else 0)
        out.append(dict(rid=i, prompt=rng.integers(0, vocab, s).astype(
            np.int32), max_new_tokens=new_tokens - (i % 2 if ragged else 0),
            arrival_cycle=i * gap, tenant=i % 2))
    return out


def _servers(arch="yi-34b"):
    """Reference and port servers at the smoke config in float32, the
    port's params carried from the reference's init."""
    jsrv = jserve.Server(arch, smoke=True)
    tsrv = tserve.Server(arch, smoke=True, device="cpu")
    cfg = dataclasses.replace(jsrv.cfg, param_dtype="float32")
    jsrv.cfg, jsrv.lm = cfg, jbuild_lm(cfg)
    jsrv.params = jsrv.lm.init(jax.random.key(0))
    jsrv._decode = jax.jit(jsrv.lm.decode_step)
    tsrv.cfg = convert.arch_config_from_dict(dataclasses.asdict(cfg))
    tsrv.lm = tbuild_lm(tsrv.cfg, device="cpu")
    tsrv.params = convert.lm_params(jax.tree.map(np.asarray, jsrv.params),
                                    "cpu")
    return jsrv, tsrv


@pytest.mark.parametrize("gap,batch", [(3, 8), (20, 8), (1, 4), (50, 16)])
def test_admit_and_kv_trace_match_reference(gap, batch):
    kw = dict(batch_size=batch, timeout_cycles=32)
    jsrv = jserve.Server("yi-34b", smoke=True, sched=JSched(**kw))
    tsrv = tserve.Server("yi-34b", smoke=True, sched=TSched(**kw),
                         device="cpu")
    reqs = _requests(n=13, gap=gap, ragged=True)
    jb = jsrv.admit([jserve.Request(**r) for r in reqs])
    tb = tsrv.admit([tserve.Request(**r) for r in reqs])
    assert [[r.rid for r in b] for b in tb] == [[r.rid for r in b]
                                                 for b in jb]
    for got, want in zip(tsrv.kv_trace(tb), jsrv.kv_trace(jb)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert tsrv.admit([]) == []


@pytest.mark.parametrize("arch,ragged", [("yi-34b", False),
                                         ("h2o-danube-1.8b", True),
                                         ("qwen2-moe-a2.7b", False),
                                         ("mamba2-2.7b", True),
                                         ("jamba-v0.1-52b", True)])
def test_serve_gives_the_reference_greedy_tokens(arch, ragged):
    """12 requests, arriving every 3 cycles (the reference CLI's mix),
    batches of 8 and 4; ragged prompts are left-padded, and h2o-danube's
    8-token window makes its cache a ring. qwen2-moe's prefill drops
    assignments past its capacity (factor 1.25) as the reference's does;
    mamba2 carries its conv taps and SSD state from prefill to decode;
    jamba's cache holds one entry per period position (attention at 4,
    Mamba at the others)."""
    jsrv, tsrv = _servers(arch)
    reqs = _requests(prompt_len=10, new_tokens=5, ragged=ragged)
    jr = [jserve.Request(**r) for r in reqs]
    tr = [tserve.Request(**r) for r in reqs]
    jstats, tstats = jsrv.serve(jr), tsrv.serve(tr)
    assert [r.output for r in tr] == [r.output for r in jr]
    for f in ("batches", "requests", "decode_steps", "prefill_tokens"):
        assert getattr(tstats, f) == getattr(jstats, f), f
    assert tstats.batches == 2 and tstats.requests == 12
    for f in ("modeled_p50_cycles", "modeled_p95_cycles",
              "modeled_p99_cycles", "modeled_makespan_cycles",
              "modeled_per_tenant", "modeled_slo_attainment"):
        assert getattr(tstats, f) == getattr(jstats, f), f
    assert tstats.modeled_p50_cycles > 0 and tstats.modeled_per_tenant
    assert tstats.prefill_s > 0 and tstats.decode_s > 0


def test_server_runs_on_the_gpu_unless_asked():
    assert inspect.signature(tserve.Server).parameters["device"].default \
        == "cuda"
    srv = tserve.Server("granite-34b", smoke=True, device="cpu")
    leaf = srv.params["layers"]["pos0"]["attn"]["wq"]
    assert leaf.device.type == "cpu" and leaf.dtype.is_floating_point
    with pytest.raises(ValueError, match="encoder"):
        tserve.Server("hubert-xlarge", smoke=True, device="cpu")


def test_cli_serves_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", [
        "serve", "--arch", "yi-34b", "--smoke", "--device", "cpu",
        "--requests", "3", "--prompt-len", "6", "--new-tokens", "2"])
    tserve.main()
    out = capsys.readouterr().out
    assert "3 requests in 1 batches" in out and "on cpu" in out
    assert "[serve] modeled KV latency (FPGA cycles): p50=" in out


@pytest.mark.parametrize("mix", ["chip", "cli"])
@pytest.mark.parametrize("slo", [None, 20000.0])
def test_model_memory_matches_reference(mix, slo):
    """``Server.model_memory`` (the KV stream replayed through the
    modeled controller, with SLO attainment and blame under ``slo_cycles``)
    gives the reference's fields at the chip script's mix (12 requests of
    1024 tokens, 16 new tokens, every 3 cycles) and at the CLI's default
    (32 tokens, 8 new), on the smoke config on both sides."""
    prompt, new = (1024, 16) if mix == "chip" else (32, 8)
    jsrv = jserve.Server("yi-34b", smoke=True, slo_cycles=slo)
    tsrv = tserve.Server("yi-34b", smoke=True, slo_cycles=slo, device="cpu")
    reqs = [dict(rid=i, prompt=np.zeros(prompt, np.int32),
                 max_new_tokens=new, arrival_cycle=i * 3) for i in range(12)]
    jstats, tstats = jserve.ServeStats(), tserve.ServeStats()
    jsrv.model_memory(jsrv.admit([jserve.Request(**r) for r in reqs]),
                      jstats)
    tsrv.model_memory(tsrv.admit([tserve.Request(**r) for r in reqs]),
                      tstats)
    for f in ("modeled_p50_cycles", "modeled_p95_cycles",
              "modeled_p99_cycles", "modeled_makespan_cycles",
              "modeled_per_tenant", "modeled_slo_attainment"):
        assert getattr(tstats, f) == getattr(jstats, f), f
    assert bool(tstats.modeled_slo_attainment) == (slo is not None)
