"""The port's `multi-pop --mesh 2,2` on the CPU (tests/test_cli_mesh.py on
the port): the two-population density through the sharded machinery,
`--resume` over the mesh, and every other sampler end to end, each run
going through one world of 4 gloo ranks spawned at the module's start
(tests/test_torch_cli_mesh.py holds the runs and the world; see its
docstring)."""
import numpy as np
import pytest
import torch

from test_torch_cli_mesh import photdir, start_mesh_world  # noqa: F401

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def mesh_world(photdir, tmp_path_factory):  # noqa: F811
    """The multi-pop runs' world (start_mesh_world)."""
    yield from start_mesh_world(photdir, tmp_path_factory, 1)


def _mp_res(photdir, outbase):
    return np.loadtxt(str(photdir / f"{outbase}.mp.res"), skiprows=1)


def test_multipop_mesh_cli(photdir, mesh_world):
    """multi-pop --mesh 2,2: the two-population density through the same
    sharded machinery, the ordered Y_A < Y_B transform intact."""
    mesh_world("mpmesh")
    raw = _mp_res(photdir, "mpmesh")
    assert raw.shape == (96, 14)  # 12 params + logPost + chain
    assert np.isfinite(raw).all()
    assert (raw[:, 10] > raw[:, 9]).all()
    assert abs(raw[:, 0].mean() - 9.5) < 0.25


def test_multipop_mesh_resume_runs(photdir, mesh_world):
    """multi-pop --mesh 2,2 --resume writes and consumes the .mp.ckpt
    checkpoint: the second invocation restores the finished run and
    rewrites identical output."""
    mesh_world("mpres1")
    mesh_world("mpres2")
    a = _mp_res(photdir, "mpres_first")
    assert (photdir / "mpres_first.mp.ckpt").exists()
    b = _mp_res(photdir, "mpres")
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("sampler", ["nuts", "vi", "smc", "mh"])
def test_multipop_sampler_breadth(photdir, mesh_world, sampler):
    """multi-pop --mesh 2,2 runs every other sampler end to end (vi:
    run_vi_sharded, smc: run_smc_sharded, mh: run_mh_sharded)."""
    mesh_world(f"mp_{sampler}")
    raw = _mp_res(photdir, f"mp_{sampler}")
    assert raw.shape[1] == 14
    assert np.isfinite(raw[:, :12]).all()
    if sampler != "mh":   # mh samples the constrained 12-vector
        assert (raw[:, 10] > raw[:, 9]).all()
    assert abs(raw[:, 0].mean() - 9.5) < 0.3
