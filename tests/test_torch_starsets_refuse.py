"""What takes one star set refuses star sets with a clear error: the
matmul form of the marginal (kernels 3m/4m and their plain versions), the
WD branch, the two-population model, the star-sharded density, the
membership and mass draws, the CLI's model; and star sets that the chains
do not split evenly.  base_tpu runs none of these over data sets."""
import os
import sys

import numpy as np
import pytest
import torch

from base_tpu_torch.model import multipop as mp
from base_tpu_torch.model import posterior as tpost
from base_tpu_torch.model.stardata import (make_ms_stars, require_one_set,
                                           stack_ms_stars)
from base_tpu_torch.ops import marglik as ml

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))
import torch_sbc  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def sets_model():
    return torch_sbc.sbc_model("ms", 4, False, "cpu", 2)[0]


def _marg_args(model, C=4):
    x = torch.from_numpy(np.tile(torch_sbc.BASE, (C, 1)))
    table, _ = tpost.ms_table(model, x)
    st = model.stars
    return (st.obs_mags, st.inv_var, st.log_norm, table.lo.contiguous(),
            table.hi.contiguous(), table.logw.contiguous(),
            table.mask.float())


def _matmul_form(model):
    ml.fused_log_marginals(*_marg_args(model), matmul=True)


def _matmul_plain(model):
    ml.marglik_mm_fwd_plain(*_marg_args(model))


def _uneven_sets(model):
    ml.marglik_fwd_plain(*_marg_args(model, C=3))


def _wd_branch(model):
    one = make_ms_stars(np.full((2, 8), 20.0, np.float32),
                        np.full((2, 8), 0.05, np.float32), device="cpu")
    tpost.make_single_pop_model(model.grid, model.stars, torch_sbc.BASE,
                                torch_sbc.PRIOR_SIGMA, wd_cooling=object(),
                                wd_atm=object(), wd_stars=one, device="cpu")


def _multipop(model):
    mp.make_multipop_model(model.grid, model.stars,
                           np.zeros(12, np.float32),
                           np.full(12, -1.0, np.float32), device="cpu")


def _star_sharded(model):
    from base_tpu_torch.parallel import run as prun
    from base_tpu_torch.parallel.mesh import Mesh

    prun.shard_stars(model, Mesh(n_chain_shards=1, n_star_shards=2, rank=0,
                                 ci=0, si=0, chain_group=None,
                                 star_group=None, device=torch.device("cpu"),
                                 backend="gloo"))


def _ms_masses(model):
    from base_tpu_torch.model.conditionals import sample_ms_masses

    sample_ms_masses(model, torch.from_numpy(torch_sbc.BASE[None]),
                     torch.Generator().manual_seed(0))


CASES = {
    "matmul form": (_matmul_form, "one star set"),
    "matmul plain": (_matmul_plain, "one star set"),
    "uneven sets": (_uneven_sets, "split evenly"),
    "WD branch": (_wd_branch, "one star set"),
    "two populations": (_multipop, "one star set"),
    "star-sharded density": (_star_sharded, "one star set"),
    "sample_ms_masses": (_ms_masses, "one star set"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_one_set_paths_refuse_star_sets(sets_model, case):
    fn, match = CASES[case]
    with pytest.raises(ValueError, match=match):
        fn(sets_model)


def test_cli_refuses_star_sets(monkeypatch):
    """The CLI's single-pop model builder (tools/main.py) refuses MS stars
    that come as star sets.  It reads one --photFile, so only a
    substituted make_ms_stars can hand it sets; with the real one the same
    table builds."""
    from base_tpu_torch import constants as C
    from base_tpu_torch.grids import filters as filt
    from base_tpu_torch.io.phot import PhotTable
    from base_tpu_torch.io.settings import load_settings
    from base_tpu_torch.model import stardata
    from base_tpu_torch.tools import main as cli

    S, bands = 3, tuple(filt.DEFAULT_BANDS)
    B = len(bands)
    table = PhotTable(
        ids=[str(i) for i in range(S)], bands=bands,
        mags=np.full((S, B), 18.0, np.float32),
        sigmas=np.full((S, B), 0.05, np.float32),
        mass1=np.ones(S, np.float32), mass_ratio=np.zeros(S, np.float32),
        stage=np.full(S, int(C.StarStatus.MSRG)),
        cm_prior=np.full(S, 0.9, np.float32), use_dbi=np.ones(S, int))
    s = load_settings(None, ["mcmc.usePallas=true"])
    model = cli._build_model_from_phot(s, table, torch.device("cpu"))
    require_one_set(model.stars, "the CLI's model")
    real = stardata.make_ms_stars
    monkeypatch.setattr(stardata, "make_ms_stars",
                        lambda *a, **k: stack_ms_stars([real(*a, **k)] * 2))
    with pytest.raises(ValueError, match="CLI"):
        cli._build_model_from_phot(s, table, torch.device("cpu"))
