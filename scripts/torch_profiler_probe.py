"""Does a short torch.profiler session keep its CUDA kernel records as the
process ages under load?  (The PyTorch/CUDA port, on one card.)

Each round runs 150 unprofiled density + gradient calls of chip_smoke's
config 1 and 40 of its config 3, then two profiler sessions of 20
launches of kernel 3 (marglik_fwd): one unpadded, one padded by
chip_smoke.PROFILE_PAD_S of idle host time on each side.  It prints, per
round, the process age, the device records each session kept out of the
launches it recorded, and the range of device-start minus launch offsets
(us).  It stops after SECONDS or after three rounds in a row in which the
unpadded session kept no device record.

    python3 scripts/torch_profiler_probe.py SECONDS

from the repository root, on a machine with a CUDA device.
"""
import os
import sys
import time

import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU


def session(marg_in, pad: float) -> str:
    from base_tpu_torch.ops import marglik as ml

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(pad)
        for _ in range(20):
            ml.marglik_fwd_cuda(*marg_in)
        torch.cuda.synchronize()
        time.sleep(pad)
    evs = prof.profiler.kineto_results.events()
    launch = {e.correlation_id(): e.start_ns() for e in evs
              if e.device_type() == CPU and e.name().startswith("cudaLaunch")}
    dev = [e for e in evs if e.device_type() == CUDA]
    off = [(e.start_ns() - launch[e.correlation_id()]) / 1e3 for e in dev
           if e.correlation_id() in launch]
    rng = f"{min(off):.1f}/{max(off):.1f}" if off else "-"
    return f"{len(dev)}/{len(launch)} offsets {rng}"


def main() -> None:
    limit_s = float(sys.argv[1])
    _, model, _, z = cs.setup(None)
    _, marg_in = cs.kernel_inputs(model, z)
    m3 = cs.make_model3(cs.make_data3(), z.device)
    z3 = cs.config3_points(m3)
    vg, vg3 = cs.density_fn(model), cs.density_fn(m3)
    print(cs.nvidia_smi(), flush=True)
    t0 = time.perf_counter()
    rnd, empty = 0, 0
    while time.perf_counter() - t0 < limit_s and empty < 3:
        for _ in range(150):
            vg(z)
        for _ in range(40):
            vg3(z3)
        torch.cuda.synchronize()
        a, b = session(marg_in, 0.0), session(marg_in, cs.PROFILE_PAD_S)
        empty = empty + 1 if a.startswith("0/") else 0
        print(f"probe age {time.perf_counter() - t0:.0f} s round {rnd}: "
              f"unpadded {a}; padded {b}", flush=True)
        rnd += 1


if __name__ == "__main__":
    main()
