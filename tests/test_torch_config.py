"""The port's own copies of the JAX-free modules (config, lattice,
io.h5out) against the JAX package's: the same parameter files parse to the
same values, the same lattices give the same index tables and info file,
and the bin writer writes the same HDF5 layout.  All exact."""

import glob
import os

import h5py
import numpy as np
import pytest

from dqmc_tpu import config as jconfig
from dqmc_tpu import lattice as jlattice
from dqmc_tpu.io import h5out as jh5out
from dqmc_tpu_torch import config as tconfig
from dqmc_tpu_torch import lattice as tlattice
from dqmc_tpu_torch.io import h5out as th5out

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = sorted(glob.glob(os.path.join(REPO, "examples", "*",
                                         "parameters.in")))


@pytest.mark.parametrize("path", EXAMPLES,
                         ids=[p.split(os.sep)[-2] for p in EXAMPLES])
def test_parameters_read_examples_as_jax(path):
    j, t = jconfig.Parameters(path), tconfig.Parameters(path)
    assert t.sections == j.sections
    assert t.dumps() == j.dumps()
    for section, keys in j.sections.items():
        for key in keys:
            for getter in ("get_str", "get_int", "get_float", "get_bool"):
                assert getattr(t, getter)(section, key, None) == \
                    getattr(j, getter)(section, key, None)


def test_parameters_typed_getters_as_jax():
    text = ("top = 1\n[a]\nx = 10_000 ; comment\ny = '2.5'\nz = true\n"
            "w = 1.0, 2.0,3\n")
    j, t = jconfig.Parameters.from_string(text), \
        tconfig.Parameters.from_string(text)
    assert t.sections == j.sections
    assert t.get_int("a", "x") == j.get_int("a", "x") == 10000
    assert t.get_float("a", "y") == j.get_float("a", "y")
    assert t.get_bool("a", "z") is j.get_bool("a", "z") is True
    assert t.get_float_list("a", "w") == j.get_float_list("a", "w")
    with pytest.raises(KeyError):
        t.get_int("a", "missing")


@pytest.mark.parametrize("geometry,L1,L2", [("square", 4, 4),
                                            ("square", 5, 3),
                                            ("triangular", 4, 4),
                                            ("honeycomb", 3, 3)])
def test_lattice_tables_match_jax(tmp_path, geometry, L1, L2):
    j = jlattice.make_lattice(geometry, L1, L2)
    t = tlattice.make_lattice(geometry, L1, L2)
    assert t.n_sites == j.n_sites and t.n_cells == j.n_cells
    np.testing.assert_array_equal(t.displacement_table(),
                                  j.displacement_table())
    np.testing.assert_array_equal(t.kspace_phases(), j.kspace_phases())
    for delta, orb_a, orb_b in jlattice.nn_bonds(geometry):
        np.testing.assert_array_equal(t.neighbor_map(delta, orb_b),
                                      j.neighbor_map(delta, orb_b))
    tp = 0.3 if geometry == "square" else 0.0
    assert tlattice.bonds_with_tp(geometry, tp) == \
        jlattice.bonds_with_tp(geometry, tp)
    j.save_info(tmp_path / "j_info")
    t.save_info(tmp_path / "t_info")
    assert (tmp_path / "t_info").read_text() == \
        (tmp_path / "j_info").read_text()


def _layout(path):
    out = {}
    with h5py.File(path, "r") as f:
        def visit(name, obj):
            out[name] = ((obj.shape, str(obj.dtype), obj[...].tobytes())
                         if isinstance(obj, h5py.Dataset) else "group")
        f.visititems(visit)
    return out


def test_bin_writer_matches_jax(tmp_path, rng):
    scalars = {"density": 0.9, "swave": 1.5}
    eq_r = {"densityCorr": rng.standard_normal((4, 4, 1))}
    eq_k = {"densityCorr": rng.standard_normal((4, 4, 1))
            + 1j * rng.standard_normal((4, 4, 1))}
    for mod, name in ((jh5out, "j.h5"), (th5out, "t.h5")):
        with mod.BinFileWriter(tmp_path / name) as w:
            for b in range(2):
                w.write_bin(b, scalars, eq_r, eq_k, {}, {})
    assert _layout(tmp_path / "t.h5") == _layout(tmp_path / "j.h5")
