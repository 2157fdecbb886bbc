"""The port's AdamW (``train/optimizer.py``) against ``repro``'s: the
schedule across the warm-up boundary and to ``total_steps``, and several
updates with clipping active and inactive. Tolerances: the schedule within
5e-7 relative (XLA's and torch's fp32 cosine may differ by an ulp each);
parameters within 1e-6 absolute; m and v within 1e-6 of the leaf's largest
magnitude; ``grad_norm`` within 1e-6 relative."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (sets the intra-op thread count)
from repro.train import optimizer as jopt
from repro_torch.train import optimizer as topt

CFG = dict(lr=1e-2, warmup_steps=5, total_steps=40, weight_decay=0.1, min_lr_ratio=0.1)


def test_schedule_matches_jax():
    jc, tc = jopt.AdamWConfig(**CFG), topt.AdamWConfig(**CFG)
    for step in range(0, CFG["total_steps"] + 3):
        want = float(jopt.schedule(jc, jnp.asarray(step, jnp.int32)))
        got = topt.schedule(tc, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=5e-7, atol=0)
    assert float(topt.schedule(tc, torch.tensor(CFG["warmup_steps"]))) == pytest.approx(1e-2)
    assert float(topt.schedule(tc, torch.tensor(CFG["total_steps"]))) == pytest.approx(1e-3)


@pytest.mark.parametrize("grad_scale,clipped", [(10.0, True), (1e-3, False)])
def test_adamw_update_matches_jax(grad_scale, clipped):
    """Five steps over three leaves; JAX's dict keys sort in the list's
    order, so both sum the global norm over the same leaves in turn."""
    rng = np.random.default_rng(int(clipped))
    shapes = {"a": (7, 3), "b": (5,), "c": (2, 4, 3)}
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    jc, tc = jopt.AdamWConfig(**CFG), topt.AdamWConfig(**CFG)
    jparams = {k: jnp.asarray(v) for k, v in p0.items()}
    jstate = jopt.adamw_init(jparams)
    tparams = [torch.tensor(p0[k]) for k in sorted(p0)]
    tstate = topt.adamw_init(tparams)
    update = jax.jit(jopt.adamw_update, static_argnums=3)
    for t in range(1, 6):
        grads = {k: (rng.normal(size=s) * grad_scale).astype(np.float32)
                 for k, s in shapes.items()}
        jparams, jstate, jm = update(jparams, {k: jnp.asarray(v) for k, v in grads.items()},
                                     jstate, jc)
        tparams, tstate, tm = topt.adamw_update(
            tparams, [torch.tensor(grads[k]) for k in sorted(grads)], tstate, tc)
        assert (float(jm["grad_norm"]) > 1.0) == clipped
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=5e-7)
        assert int(tstate["step"]) == int(jstate["step"]) == t
        for i, k in enumerate(sorted(p0)):
            np.testing.assert_allclose(tparams[i].numpy(), np.asarray(jparams[k]),
                                       rtol=0, atol=1e-6)
            for name in ("m", "v"):
                assert tstate[name][i].dtype == torch.float32
                want = np.asarray(jstate[name][k])
                np.testing.assert_allclose(tstate[name][i].numpy(), want, rtol=0,
                                           atol=1e-6 * float(np.abs(want).max()))


def test_global_norm_and_state_layout():
    xs = [torch.full((3,), 2.0), torch.full((2, 2), -1.0, dtype=torch.bfloat16)]
    assert float(topt.global_norm(xs)) == pytest.approx((12.0 + 4.0) ** 0.5)
    st = topt.adamw_init(xs)
    assert [m.dtype for m in st["m"]] == [torch.float32] * 2
    assert st["step"].dtype == torch.int32 and int(st["step"]) == 0
