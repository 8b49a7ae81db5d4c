"""PyTorch port vs JAX reference: ``Model.loss`` gradients of the families
that train through kernel #1 (the LUT exponential), on the CPU.

granite-moe-3b-a800m-smoke and grok-1-314b-smoke (the MoE router's softmax
on #1), falcon-mamba-7b-smoke (Mamba-1's Ā = exp(Δ ⊗ A) on #1) and
zamba2-1.2b-smoke (Mamba-2's decays on #1, a shared attention block): the
reference's weights with every bias and norm scale perturbed
(``_torch_twin.perturbed``), f32, a batch of 2 × 24 seeded tokens and
labels; ``jax.grad`` of the reference's ``Model.loss`` against autograd of
the port's, which runs ``_LutExp`` (the kernel wrapper's Function, its
plain backward ``lut_exp_bwd_ref`` on the CPU).  Every leaf is held
relative to its largest element.

The rule, ``max(3e-5, 3·S)``: both sides sum the same f32 products in
other orders (the exact exponential holds 3e-5 flat: the zamba2 case in
``exact`` mode below), and one more thing moves the LUT's gradient.  Its
derivative 2^n·T[d] is a step function of x (128 steps an octave, each
2^(1/128) − 1 ≈ 0.54%), so an ulp of a LUT input on a table boundary —
and the two frameworks' matmuls and cumulative sums leave ulps there —
moves that term by a whole step.  S is how far that moves the port's own
gradients: the largest change, over leaves and relative to the leaf's
largest element, when every LUT input is nudged one ulp up or one ulp
down.  Measured on this batch (worst leaf; S): granite 4.9e-6 (3.5e-5),
grok 9.3e-6 (3.2e-5), falcon 2.6e-5 (1.8e-6), zamba2 9.3e-5 at its
``A_log`` (8.6e-5: limit 2.6e-4) and 1.9e-5 with the exact exponential.
Over five seeds zamba2's Mamba-2 leaves (``A_log``, ``dt_bias``,
``conv_w``) sat 2e-5 to 9e-5 from the reference, the others within
2.6e-5.  A wrong derivative (a missing factor, a sign, order 0's zero)
moves a leaf by O(1).  One intra-op thread; ~45 s alone.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread per test process
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.store import flatten_tree  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
import repro_torch.models.mamba as t_mamba  # noqa: E402
import repro_torch.models.moe as t_moe  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.lut_exp.ops import lut_exp as t_lut_exp  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.params import from_flat, to_flat  # noqa: E402
from tests._torch_twin import perturbed  # noqa: E402

TOL = 3e-5
CASES = [("granite-moe-3b-a800m-smoke", "lut"), ("grok-1-314b-smoke", "lut"),
         ("falcon-mamba-7b-smoke", "lut"), ("zamba2-1.2b-smoke", "lut"),
         ("zamba2-1.2b-smoke", "exact")]


def nudged(lut_exp, direction):
    """``lut_exp`` with every finite input moved one ulp towards
    ``direction`` (the gradient still flows to the unmoved input)."""
    def fn(z, order=1):
        zd = z.detach()
        step = torch.nextafter(zd, torch.full_like(zd, direction)) - zd
        return lut_exp(z + torch.where(torch.isfinite(zd), step, 0.0),
                       order=order)
    return fn


def port_grads(cfg, params, batch):
    keys = list(params)
    leaves = [params[k].detach().requires_grad_() for k in keys]
    loss, _ = build_model(cfg).loss(dict(zip(keys, leaves)), batch)
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), {k: v.numpy() for k, v in to_flat(
        dict(zip(keys, grads)), cfg).items()}


@pytest.mark.parametrize("arch,mode", CASES)
def test_loss_gradients_match_jax_grad(monkeypatch, arch, mode):
    jcfg = j_get_config(arch).replace(dtype="float32", exp_mode=mode)
    tcfg = get_config(arch).replace(dtype="float32", exp_mode=mode)
    jm = j_build_model(jcfg)
    params = perturbed(jm.init(jax.random.PRNGKey(0)), 3)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 24)).astype(np.int32)
    labels = rng.integers(0, jcfg.vocab_size, (2, 24)).astype(np.int32)
    jloss, jgrads = jax.value_and_grad(lambda p: jm.loss(p, {
        "tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)})[0])(
            params)
    want = flatten_tree(jgrads)
    tparams = from_flat(flatten_tree(params), tcfg, "cpu")
    batch = {"tokens": torch.from_numpy(tokens),
             "labels": torch.from_numpy(labels)}
    loss, got = port_grads(tcfg, tparams, batch)
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-6)
    assert set(got) == set(want)
    scale = {k: max(float(np.abs(w).max()), 1e-30) for k, w in want.items()}
    spread = 0.0
    if mode != "exact":
        for direction in (np.inf, -np.inf):
            for mod in (t_mamba, t_moe):
                monkeypatch.setattr(mod, "lut_exp", nudged(t_lut_exp,
                                                           direction))
            _, moved = port_grads(tcfg, tparams, batch)
            monkeypatch.undo()
            spread = max(spread, max(float(np.abs(moved[k] - got[k]).max())
                                     / scale[k] for k in got))
    limit = max(TOL, 3 * spread)
    errs = {k: float(np.abs(got[k] - want[k]).max()) / scale[k] for k in got}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= limit, (
        f"{worst}: {errs[worst]:.3g} of its largest element, limit "
        f"{limit:.3g} (one-ulp LUT spread {spread:.3g})")
