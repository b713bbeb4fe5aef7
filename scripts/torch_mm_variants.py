"""Where kernels 3m and 4m (base_tpu_torch/csrc/marglik_mm.cu) spend their
time, by variants of the source timed side by side on one card.

Each variant is the source with one change (a constant, a pragma, or a
phase cut out, named below); nvcc builds every variant into its own
library (with csrc/status.cu), all builds started together, and each is
loaded in turn behind the ops/marglik.py wrappers.  The outputs of the
variants that change only unrolling or occupancy are compared with the
source's bit for bit; the others are timings only.  Device ms (chip_smoke's
device_ms) of 3m and 4m at the bench shapes (config 1, C 64, S 100, T
504, B 8) and on a 29-band stand-in for the CLI's model (a synthetic grid
of 80 EEPs in every filter of grids/filters.py, 96 stars, n_q 16,
upsample 4: C 64, S 96, T 5056), two rounds in opposite orders, then
kernels 3 and 4 on the same inputs.

    python3 scripts/torch_mm_variants.py [NAME ...]
    python3 scripts/torch_mm_variants.py --sass

from the repository root, on a machine with a CUDA device and nvcc; the
libraries go to base_tpu_torch/_build/variants/.  `--sass` instead prints
the instruction mix of every loop of kernel 3m's SASS (cuobjdump of the
built library) that holds 40 FFMA or more: the band loop of its
contraction.
"""
import collections
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402
from base_tpu_torch.ops import build  # noqa: E402
from base_tpu_torch.ops import marglik as ml  # noqa: E402

SOURCE = build.CSRC / "marglik_mm.cu"
OUT = build.BUILD_DIR / "variants"


def _sub(text, old, new):
    if old not in text:
        raise SystemExit(f"variant: {old!r} not in {SOURCE.name}")
    return text.replace(old, new)


def _consts(text, **values):
    for name, value in values.items():
        text, n = re.subn(rf"constexpr (int|long) {name} = [^;]+;",
                          rf"constexpr \1 {name} = {value};", text)
        if n != 1:
            raise SystemExit(f"variant: constant {name} not found")
    return text


def variants(src: str) -> dict:
    """{name: (source text, same function as the source?)}."""
    loop = "    Abg x[F_SPT][F_TPT] = {};\n#pragma unroll 4\n"
    return {
        "source": (src, True),
        # 3m: the core_width of each element replaced by a few adds.
        "3m_no_core_width": (_sub(
            src,
            "        const Segment g = expanded_core_width(\n"
            "            x[k][j], s_c0[sw * F_SPT + k], s_lw[tt]);",
            "        Segment g;\n"
            "        g.core = x[k][j].a - x[k][j].b1 + x[k][j].g2 + s_lw[tt];\n"
            "        g.width = x[k][j].b2 + x[k][j].g1;"), False),
        # 3m: other chunkings and tiles (their merges run in other orders).
        "3m_1_wave": (_consts(src, F_TARGET_BLOCKS="1 * 3 * 132"), False),
        "3m_2_waves": (_consts(src, F_TARGET_BLOCKS="2 * 3 * 132"), False),
        "3m_4_waves": (_consts(src, F_TARGET_BLOCKS="4 * 3 * 132"), False),
        "3m_32_stars": (_consts(src, F_SW=8, F_TW=1), False),
        "3m_8x1_tile": (_consts(src, F_SW=2, F_TW=4, F_SPT=8, F_TPT=1),
                        False),
        "3m_no_unroll": (_sub(src, loop, loop.replace(
            "#pragma unroll 4\n", "")), True),
        "3m_two_blocks": (_consts(src, F_MINB=2), True),
        # 4m: phases cut out.
        "4m_no_kept_stars": (_sub(
            src, "const int nk = __popc(k0) + __popc(s_keep[1]);",
            "const int nk = 0 * (__popc(k0) + __popc(s_keep[1]));"), False),
        "4m_no_star_tiles": (_sub(
            src, "const int ntiles = any_live ? (S + G_ST - 1) / G_ST : 0;",
            "const int ntiles = 0;"), False),
        "4m_two_blocks_narrow": (_sub(
            src, "MB <= btt::NARROW_B ? 3 : 2)", "2)"), True),
    }


def build_all(chosen: dict) -> dict:
    """{name: loaded library}, every nvcc started together."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (text, _) in chosen.items():
        cu = OUT / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-I",
             str(build.CSRC), "-o", str(OUT / f"{name}.so"), str(cu),
             str(build.CSRC / "status.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        text, _ = p.communicate()
        regs = [ln.split("info    :")[-1].strip()
                for ln in text.splitlines() if "Used" in ln
                or ("spill" in ln and " 0 bytes spill" not in ln)]
        cs.log(f"{name}: nvcc {p.returncode}; {regs}")
        if p.returncode != 0:
            raise SystemExit(text[-3000:])
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        for sym in ("btt_marglik_mm_fwd", "btt_marglik_mm_bwd"):
            getattr(lib, sym).argtypes = build._SIGNATURES[sym]
            getattr(lib, sym).restype = ctypes.c_int
        lib.btt_marglik_mm_fwd_scratch.argtypes = [ctypes.c_int] * 3
        lib.btt_marglik_mm_fwd_scratch.restype = ctypes.c_longlong
        libs[name] = lib
    return libs


class _Library:
    """A variant's 3m / 4m entry points, the built library's others."""

    def __init__(self, variant, real):
        self.variant, self.real = variant, real

    def __getattr__(self, name):
        lib = self.variant if name.startswith("btt_marglik_mm") else self.real
        return getattr(lib, name)


def use(lib, real) -> None:
    wrapped = _Library(lib, real)
    build.library = lambda: wrapped
    build.marglik_mm_fwd_scratch = lambda C, S, T: int(
        wrapped.btt_marglik_mm_fwd_scratch(C, S, T))


def wide_model(dev):
    """The 29-band stand-in for the CLI's model (module docstring)."""
    from base_tpu_torch.grids import filters, synthetic
    from base_tpu_torch.model import posterior as post
    from base_tpu_torch.model.stardata import make_ms_stars
    from base_tpu_torch.sim.scatter import scatter_cluster
    from base_tpu_torch.sim.simulate import simulate_cluster

    bands = tuple(filters.FILTERS)
    grid = synthetic.make_grid(n_eep=80, bands=bands, device="cpu")
    gen = torch.Generator().manual_seed(0)
    cat = simulate_cluster(grid, torch.as_tensor(cs.TRUTH), 96, gen,
                           percent_binary=0.3)
    sc = scatter_cluster(cat.mags, gen, limit_mag=24.0)
    stars = make_ms_stars(sc.mags.numpy(), sc.sigmas.numpy(),
                          cm_prior=0.99, device=dev)
    return post.make_single_pop_model(
        synthetic.make_grid(n_eep=80, bands=bands, device=dev), stars,
        cs.TRUTH, cs.PRIOR_SIGMA, n_q=16, upsample=4, device=dev)


def sass_loops(text: str) -> list:
    """The instruction mix of 3m's loops of 40 FFMA or more in the SASS
    `text` (a loop: the instructions from a backward branch's target to
    the branch)."""
    fn = text.split("Function : ")
    body = next(f for f in fn[1:] if "marglik_mm_fwd_kernel" in
                f.splitlines()[0])
    ins = [(int(m.group(1), 16), m.group(2), m.group(3)) for m in re.finditer(
        r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);",
        body)]
    loops = []
    for addr, op, rest in ins:
        target = re.search(r"0x([0-9a-f]+)", rest)
        if not op.startswith("BRA") or not target:
            continue
        start = int(target.group(1), 16)
        if start >= addr:
            continue
        loop = collections.Counter(o if o.startswith("LDS") else
                                   o.split(".")[0] for a, o, _ in ins
                                   if start <= a <= addr)
        if loop["FFMA"] >= 40:
            loops.append({"loop": [hex(start), hex(addr)],
                          "instructions": sum(loop.values()),
                          "mix": dict(loop.most_common())})
    return loops


def main() -> None:
    if sys.argv[1:] == ["--sass"]:
        cuobjdump = shutil.which("cuobjdump") or str(
            Path(build._nvcc()).parent / "cuobjdump")
        for loop in sass_loops(subprocess.run(
                [cuobjdump, "-sass", str(build.build())], check=True,
                capture_output=True, text=True).stdout):
            print(json.dumps(loop))
        return
    chosen = variants(SOURCE.read_text())
    if sys.argv[1:]:
        chosen = {k: chosen[k] for k in ["source", *sys.argv[1:]]}
    t0 = time.perf_counter()
    libs = build_all(chosen)
    cs.log(f"variant builds: {time.perf_counter() - t0:.1f} s")
    _, model, _, _ = cs.setup(None)
    real = build.library()
    dev = torch.device("cuda", 0)
    inputs = {}
    for label, m in (("bench", model), ("b29", wide_model(dev))):
        marg_in = cs.kernel_inputs(m, cs.chain_points(m, 0.05, seed=1))[1]
        obs, lo, hi = ml.center_bands(*marg_in[:2], *marg_in[3:5])
        cent = (obs, marg_in[1], marg_in[2], lo, hi, *marg_in[5:])
        out = ml.marglik_mm_fwd_plain(*cent)
        g = torch.randn(out.shape, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(3))
        inputs[label] = (marg_in, cent, out, g)
    ref = {}
    use(libs["source"], real)
    for label, (_, cent, out, g) in inputs.items():
        ref[label] = (ml.marglik_mm_fwd_cuda(*cent),
                      ml.marglik_mm_bwd_cuda(*cent, out, g))
    res = {name: {label: [] for label in inputs} for name in libs}
    for order in (list(libs), list(reversed(libs))):
        for name in order:
            use(libs[name], real)
            for label, (_, cent, out, g) in inputs.items():
                fwd = cs.device_ms(lambda: ml.marglik_mm_fwd_cuda(*cent))
                bwd = cs.device_ms(
                    lambda: ml.marglik_mm_bwd_cuda(*cent, out, g))
                res[name][label].append((fwd, bwd))
    report = {}
    for name, by_label in res.items():
        use(libs[name], real)
        report[name] = {}
        for label, times in by_label.items():
            _, cent, out, g = inputs[label]
            same = None
            if chosen[name][1]:
                o, b = ref[label]
                same = bool(torch.equal(ml.marglik_mm_fwd_cuda(*cent), o)
                            and all(torch.equal(x, y) for x, y in zip(
                                ml.marglik_mm_bwd_cuda(*cent, out, g), b)))
            report[name][label] = dict(
                fwd_ms=[t[0] for t in times], bwd_ms=[t[1] for t in times],
                bit_identical=same)
        cs.log(f"{name:22s} " + "  ".join(
            f"{k}: 3m {v['fwd_ms'][0]:.5f} {v['fwd_ms'][1]:.5f}, 4m "
            f"{v['bwd_ms'][0]:.5f} {v['bwd_ms'][1]:.5f}, same "
            f"{v['bit_identical']}" for k, v in report[name].items()))
    use(real, real)
    for label, (marg_in, _, _, _) in inputs.items():
        out = ml.marglik_fwd_plain(*marg_in)
        gs = torch.ones_like(out)
        report[f"kernels 3, 4 ({label})"] = (
            cs.device_ms(lambda: ml.marglik_fwd_cuda(*marg_in)),
            cs.device_ms(lambda: ml.marglik_bwd_cuda(*marg_in, out, gs)))
    print(json.dumps(report))
    print(cs.nvidia_smi())


if __name__ == "__main__":
    main()
