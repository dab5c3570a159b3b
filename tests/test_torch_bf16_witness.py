"""bf16 serve consistency, in both packages on the same weights: a decode
step against the cache-free forward of the same prefix and, for an SSM,
the stepwise decode from a zero cache against the chunked forward at
every position, each as max |diff| over the forward's largest logit
magnitude, and the port's forward against the reference's. The
reference's params are converted leaf for leaf; MoE models run at a
capacity factor of their expert count, so nothing drops. Both run on
the CPU: the reference's model through its XLA attention, the port's
through its wrappers' plain versions.

The tests hold the port's bf16 readings to the reference's on the smoke
configs: no larger than twice the reference's plus 1e-3, and the float32
readings within the float32 parity tolerance 1e-4.

Run as a script for the readings at a model's full width with its depth
cut (one JSON line per model and dtype; about 6 minutes on 8 CPU
cores)::

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_bf16_witness.py
"""

import dataclasses
import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import build_lm as jbuild_lm
from repro_torch import convert
from repro_torch.models import build_lm as tbuild_lm

F32_TOL = 1e-4
# (arch, layers kept, batch, prompt tokens): SSM prompts cross a 256-token
# chunk with a ragged tail; MoE prompts are short, because at capacity = the
# tokens every expert multiplies every token.
FULL_WIDTH = [("mamba2_2p7b", 4, 2, 300), ("qwen2_moe_a2p7b", 2, 2, 64)]
SMOKE = [("mamba2_2p7b", 2, 40), ("qwen2_moe_a2p7b", 2, 24),
         ("jamba_v0p1_52b", 2, 24)]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rel(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _models(arch, smoke, layers, dtype):
    cfg = jget_arch(arch, smoke=smoke)
    reps = dict(param_dtype=dtype)
    if layers is not None:
        reps["num_layers"] = layers
    if cfg.moe is not None:
        reps["moe"] = dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.num_experts))
    jcfg = dataclasses.replace(cfg, **reps)
    tcfg = convert.arch_config_from_dict(dataclasses.asdict(jcfg))
    jlm, tlm = jbuild_lm(jcfg), tbuild_lm(tcfg, device="cpu")
    jparams = jlm.init(jax.random.key(0))
    tparams = convert.lm_params(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jlm, jparams, tlm, tparams


def _reference(jlm, params, toks, stepwise):
    """The reference's forward logits, its decode step of the last token
    after a prefill of the others, and its stepwise decode logits."""
    V = jlm.cfg.vocab_size
    B, S = toks.shape
    fwd = jax.jit(jlm.forward)(params, {"tokens": jnp.asarray(toks)})[0]
    fwd = fwd[..., :V]
    _, cache, cur = jax.jit(jlm.prefill, static_argnums=2)(
        params, {"tokens": jnp.asarray(toks[:, :-1])}, S)
    dec = jax.jit(jlm.decode_step)
    step = dec(params, jnp.asarray(toks[:, -1]), cache, cur)[0]
    steps = []
    if stepwise:
        cache = jlm.init_cache(B, S)
        for t in range(S):
            logits, cache = dec(params, jnp.asarray(toks[:, t]), cache,
                                jnp.int32(t))
            steps.append(logits)
    return fwd, step, steps


def _port(tlm, params, toks, stepwise):
    """The port's counterparts of ``_reference``."""
    V = tlm.cfg.vocab_size
    B, S = toks.shape
    t = torch.from_numpy(toks)
    with torch.no_grad():
        fwd = tlm.forward(params, {"tokens": t})[0][..., :V]
        _, cache, cur = tlm.prefill(params, {"tokens": t[:, :-1]}, S)
        step = tlm.decode_step(params, t[:, -1].contiguous(), cache, cur)[0]
        steps = []
        if stepwise:
            cache = tlm.init_cache(B, S)
            for i in range(S):
                logits, cache = tlm.decode_step(
                    params, t[:, i].contiguous(), cache, i)
                steps.append(logits)
    return fwd, step, steps


def _summary(fwd, step, steps) -> dict:
    out = {"decode_vs_forward": _rel(step, fwd[:, -1])}
    if steps:
        errs = [_rel(s, fwd[:, i]) for i, s in enumerate(steps)]
        worst = int(np.argmax(errs))
        out.update(stepwise=errs[worst], stepwise_worst_position=worst)
    return out


def readings(arch, *, smoke, layers, batch, prompt, dtype) -> dict:
    """Both packages' readings for one model and dtype, on token ids drawn
    uniformly from seed 0."""
    jcfg, jlm, jparams, tlm, tparams = _models(arch, smoke, layers, dtype)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jcfg.vocab_size, (batch, prompt)).astype(np.int32)
    stepwise = jcfg.family == "ssm"
    ref = _reference(jlm, jparams, toks, stepwise)
    port = _port(tlm, tparams, toks, stepwise)
    return dict(arch=jcfg.name, layers=jcfg.num_layers,
                d_model=jcfg.d_model, batch=batch, prompt=prompt,
                dtype=dtype, reference=_summary(*ref), port=_summary(*port),
                port_vs_reference_forward=_rel(port[0], ref[0]))


@pytest.mark.parametrize("arch,batch,prompt", SMOKE)
def test_port_bf16_drift_is_the_references(arch, batch, prompt):
    r = readings(arch, smoke=True, layers=None, batch=batch, prompt=prompt,
                 dtype="bfloat16")
    for k, want in r["reference"].items():
        if not k.endswith("_position"):
            assert r["port"][k] <= 2 * want + 1e-3, (k, r)


@pytest.mark.parametrize("arch,batch,prompt", SMOKE)
def test_float32_drift_is_within_parity_tolerance(arch, batch, prompt):
    r = readings(arch, smoke=True, layers=None, batch=batch, prompt=prompt,
                 dtype="float32")
    for side in ("reference", "port"):
        for k, v in r[side].items():
            if not k.endswith("_position"):
                assert v <= F32_TOL, (side, k, r)
    assert r["port_vs_reference_forward"] <= F32_TOL, r


def main() -> int:
    for arch, layers, batch, prompt in FULL_WIDTH:
        for dtype in ("bfloat16", "float32"):
            t0 = time.perf_counter()
            r = readings(arch, smoke=False, layers=layers, batch=batch,
                         prompt=prompt, dtype=dtype)
            r["host_s"] = time.perf_counter() - t0
            print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
