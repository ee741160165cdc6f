"""dqmc_tpu_torch's HS field and attractive Hubbard model against dqmc_tpu
at float64: the GHQ tables exactly, the model's matrices and update math to
1e-14 (both packages take the same scipy expm in host f64)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dqmc_tpu import hsfield as jhs
from dqmc_tpu.lattice import bonds_with_tp, make_lattice, square_lattice
from dqmc_tpu.models import AttractiveHubbard
from dqmc_tpu.models import attractive_hubbard as jah
from dqmc_tpu.models import kinetic as jkin
from dqmc_tpu_torch import hsfield as ths
from dqmc_tpu_torch.engine.state import make_generators
from dqmc_tpu_torch.models import AttractiveHubbard as TAttractiveHubbard
from dqmc_tpu_torch.models import attractive_hubbard as tah
from dqmc_tpu_torch.models import kinetic as tkin
from torch_port_util import (  # noqa: F401
    release_jax_programs,
    to_np,
    torch_model)

torch.set_num_threads(1)


def test_hsfield_tables_exact():
    np.testing.assert_array_equal(ths.GAMMA, jhs.GAMMA)
    np.testing.assert_array_equal(ths.ETA, jhs.ETA)
    np.testing.assert_array_equal(ths.PROPOSAL, jhs.PROPOSAL)
    old = torch.arange(4)[:, None].expand(4, 3)
    r = torch.arange(3)[None, :].expand(4, 3)
    np.testing.assert_array_equal(ths.new_state(old, r).numpy(),
                                  jhs.PROPOSAL)


@pytest.mark.parametrize("g,sign", [(0.3, -1.0), (0.3, 1.0), (0.05, -1.0),
                                    (1.2, 1.0)])
def test_log_gamma_eta_sums_matches_jax(rng, g, sign):
    fields = rng.integers(0, 4, (12, 16))
    jb, jg = jhs.log_gamma_eta_sums(jnp.asarray(fields),
                                    jnp.asarray(g, jnp.float64), sign)
    tb, tg = ths.log_gamma_eta_sums(torch.as_tensor(fields),
                                    torch.tensor(g, dtype=torch.float64),
                                    sign)
    np.testing.assert_allclose(float(tb), float(jb), rtol=1e-14)
    np.testing.assert_allclose(float(tg), float(jg), rtol=1e-14)


@pytest.mark.parametrize("nt,ns", [(8, 16), (1, 4), (40, 36)])
def test_field_draws(nt, ns):
    gen = make_generators(1, 1, "cpu")[0]
    f = ths.init_fields(gen, nt, ns)
    assert f.shape == (nt, ns) and f.min() >= 0 and f.max() <= 3
    new = ths.propose_new_fields(gen, f)
    assert (new != f).all() and new.min() >= 0 and new.max() <= 3


@pytest.mark.parametrize("geometry,L,tp", [("square", 4, 0.0),
                                           ("square", 6, 0.2),
                                           ("honeycomb", 3, 0.0),
                                           ("square", 2, 0.0),
                                           ("square", 4, -0.3),
                                           ("triangular", 3, 0.0),
                                           ("triangular", 4, 0.0),
                                           ("honeycomb", 2, 0.0)])
def test_model_matrices_match_jax(geometry, L, tp):
    lat = make_lattice(geometry, L, L)
    bonds = bonds_with_tp(geometry, tp)
    kw = dict(U=4.0, t=1.0, mu=-0.1, beta=4.0, nt=12, bonds=bonds)
    jm = AttractiveHubbard.build(lat, dtype=jnp.float64, **kw)
    tm = TAttractiveHubbard.build(lat, dtype=torch.float64, **kw)
    np.testing.assert_array_equal(
        tah.build_kinetic_matrix(lat, 1.0, -0.1, bonds),
        jah.build_kinetic_matrix(lat, 1.0, -0.1, bonds))
    for name in ("expK", "invexpK", "expK_half", "invexpK_half", "g",
                 "alpha", "eta", "gamma", "beta"):
        np.testing.assert_allclose(to_np(getattr(tm, name)),
                                   np.asarray(getattr(jm, name)),
                                   rtol=1e-14, atol=1e-14, err_msg=name)
    assert (tm.n_sites, tm.nt, tm.n_flavor, tm.det_power) == \
        (jm.n_sites, jm.nt, jm.n_flavor, jm.det_power)


@pytest.mark.parametrize("U", [4.0, 1.0, 8.0])
def test_update_math_matches_jax(rng, U):
    lat = square_lattice(4, 4)
    jm = AttractiveHubbard.build(lat, U=U, t=1.0, mu=-0.1, beta=4.0,
                                 nt=12, dtype=jnp.float64)
    tm = torch_model(jm)
    old = rng.integers(0, 4, 32)
    new = np.asarray(jhs.PROPOSAL)[old, rng.integers(0, 3, 32)]
    jf = jax.vmap(jm.update_factors)(jnp.asarray(old), jnp.asarray(new))
    tf = tm.update_factors(torch.as_tensor(old), torch.as_tensor(new))
    for a, b in zip(jf, tf):
        np.testing.assert_allclose(to_np(b), np.asarray(a), rtol=1e-14)
    G_ii = rng.random((32, 1))
    delta = np.asarray(jf[2])
    jr = jax.vmap(jm.det_ratio)(jnp.asarray(G_ii), jnp.asarray(delta))
    tr = tm.det_ratio(torch.as_tensor(G_ii), torch.as_tensor(delta))
    np.testing.assert_allclose(to_np(tr), np.asarray(jr), rtol=1e-14)
    fields = rng.integers(0, 4, (12, 16))
    log_det = rng.standard_normal(1)
    np.testing.assert_allclose(
        float(tm.global_action(torch.as_tensor(fields),
                               torch.as_tensor(log_det))),
        float(jm.global_action(jnp.asarray(fields), jnp.asarray(log_det))),
        rtol=1e-14)


@pytest.mark.parametrize("L", [4, 2])
@pytest.mark.parametrize("name", ["apply_B_left", "apply_B_right",
                                  "apply_invB_left", "apply_invB_right"])
def test_kinetic_products_match_jax(rng, name, L):
    ns = L * L
    lat = square_lattice(L, L)
    jm = AttractiveHubbard.build(lat, U=4.0, t=1.0, mu=-0.1, beta=4.0,
                                 nt=12, dtype=jnp.float64)
    tm = torch_model(jm)
    fields = rng.integers(0, 4, (3, ns))
    X = rng.standard_normal((3, 1, ns, ns))
    want = jax.vmap(lambda f, x: getattr(jkin, name)(jm, f, x))(
        jnp.asarray(fields), jnp.asarray(X))
    got = getattr(tkin, name)(tm, torch.as_tensor(fields),
                              torch.as_tensor(X))
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-13,
                               atol=1e-14)


def test_checkerboard_raises():
    """Checkerboard kinetics are refused where the JAX package's build
    refuses them, with a ValueError in both packages: odd L, another
    geometry, t' != 0 (tests/test_torch_checkerboard.py holds what
    runs)."""
    from dqmc_tpu_torch.lattice import square_lattice as tsquare_lattice
    for (L1, L2), geometry, tp, match in (
            ((6, 3), "square", 0.0, "even L1, L2"),
            ((4, 4), "triangular", 0.0, "square lattice only"),
            ((4, 4), "square", 0.2, "square lattice only")):
        for cls, lat in ((AttractiveHubbard, square_lattice(L1, L2)),
                         (TAttractiveHubbard, tsquare_lattice(L1, L2))):
            with pytest.raises(ValueError, match=match):
                cls.build(lat, U=4.0, t=1.0, mu=0.0, beta=2.0, nt=8,
                          checkerboard=True,
                          bonds=bonds_with_tp(geometry, tp))
