#!/usr/bin/env python3
"""Where the DFD kernel's time goes, on one GPU.

Run from the repository root: ``python3 scripts/dfd_probe.py [--out FILE]``.
It builds variants of ``pyannote_video_tpu_torch/csrc/dfd.cu`` into
``build/kernels/probe/`` (one ``nvcc`` each, all started together):

* full: the kernel as it is;
* stage: the copies into shared memory only (the compute is left out);
* compute: the compute only (no copies: it reads whatever shared memory
  holds, so its output is not checked);
* empty: neither: launch, barriers, the per-pair sums and the write;
* regs2: the kernel with two CTAs per SM in its launch bounds instead of
  three, which lets ptxas use ~126 registers instead of 80;
* clocks: the kernel with per-warp ``clock64`` stamps (start, copies in,
  compute done, end), its SM and warp slot, written to the scratch buffer.

For each shape it prints the time per launch of every variant (100
launches captured in one CUDA graph, replayed between CUDA events) and the
error of the full and regs2 variants against ``dfd_series_plain``.  At
[257, 50, 89] it adds percentiles of the per-warp staging and compute
cycles and the number of CTAs each SM ran.  One JSON object, also written
to ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from collections import Counter
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

SHAPES = [(257, 50, 89), (257, 50, 67), (65, 144, 256), (4097, 50, 89)]
CLOCK_SHAPE = (257, 50, 89)

# exact source lines each variant changes
COPIES = "    for (int i = lane; i < (pairs + 1) * segs; i += 32) {"
COMPUTE = "  if (k < pairs && by0 + ly < n_by && bx0 + lx < n_bx) {"
BOUNDS = "__launch_bounds__(kMaxThreads, 3)"
START = "  const int tile = blockIdx.x % p.n_tiles;"
STAGED = "  const int per_pair = p.band * p.tile_bx;"
COMPUTED = "  // per pair: lane-strided sums"
KERNEL_END = "\n}\n\n// out[p] = (sum of partial"
CLOCK_HELPERS = """
__device__ __forceinline__ unsigned probe_sreg_smid() {
  unsigned v; asm volatile("mov.u32 %0, %%smid;" : "=r"(v)); return v; }
__device__ __forceinline__ unsigned probe_sreg_warpid() {
  unsigned v; asm volatile("mov.u32 %0, %%warpid;" : "=r"(v)); return v; }
"""
CLOCK_RECORD = """
  __syncwarp();
  if (lane == 0) {
    long long* rec = (long long*)partial + ((size_t)blockIdx.x * 8 + warp) * 6;
    rec[0] = probe_sreg_smid(); rec[1] = probe_sreg_warpid();
    rec[2] = c1 - c0; rec[3] = c2 - c1; rec[4] = clock64() - c0; rec[5] = 1;
  }"""


def _replace(src: str, old: str, new: str) -> str:
    if old not in src:
        raise SystemExit(f"dfd_probe: source line not found: {old!r}")
    return src.replace(old, new)


def variants(src: str) -> dict:
    clocks = _replace(src, START, "  const long long c0 = clock64();\n" + START)
    clocks = _replace(clocks, STAGED, "  const long long c1 = clock64();\n" + STAGED)
    clocks = _replace(clocks, COMPUTED, "  const long long c2 = clock64();\n" + COMPUTED)
    clocks = _replace(clocks, KERNEL_END, CLOCK_RECORD + KERNEL_END)
    clocks = _replace(clocks, "namespace {\n", "namespace {\n" + CLOCK_HELPERS)
    return {
        "full": src,
        "stage": _replace(src, COMPUTE, "  if (false) {"),
        "compute": _replace(src, COPIES, COPIES.replace("(pairs + 1) * segs", "0")),
        "empty": _replace(_replace(src, COMPUTE, "  if (false) {"), COPIES,
                          COPIES.replace("(pairs + 1) * segs", "0")),
        "regs2": _replace(src, BOUNDS, "__launch_bounds__(kMaxThreads, 2)"),
        "clocks": clocks,
    }


def build(sources: dict, out_dir: Path):
    """The loaded library of each variant, and ptxas's report on each."""
    import chip_smoke
    from pyannote_video_tpu_torch.utils import cuda_build

    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        cu = out_dir / f"dfd_{name}.cu"
        cu.write_text(src)
        procs[name] = subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS,
             "-o", str(out_dir / f"libdfd_{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, ptxas = {}, {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"dfd_probe: nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(out_dir / f"libdfd_{name}.so"))
        ptxas[name] = {k: v for k, v in chip_smoke.ptxas_report(log).items()
                       if "radius=3" in k}
    return libs, ptxas


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("dfd_probe: no CUDA device", file=sys.stderr)
        return 2

    import chip_smoke
    from pyannote_video_tpu_torch.ops import dfd as D
    from pyannote_video_tpu_torch.utils import cuda_build

    src = (cuda_build.CSRC / "dfd.cu").read_text()
    libs, ptxas = build(variants(src), cuda_build.BUILD_DIR / "probe")
    for lib in libs.values():
        lib.dfd_prepare.restype = ctypes.c_int
        lib.dfd_series_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.POINTER(D._CPlan), ctypes.c_int, ctypes.c_void_p]
        lib.dfd_series_launch.restype = ctypes.c_int
        if lib.dfd_prepare() < 0:
            raise SystemExit("dfd_probe: dfd_prepare failed")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    result = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
              "us_per_launch": {}, "max_abs_err": {},
              "ptxas": {k: ptxas[k] for k in ("full", "regs2")}}
    rng = np.random.default_rng(chip_smoke.SEED)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for shape in SHAPES:
        gray = torch.from_numpy(rng.uniform(0, 255, shape).astype(np.float32)).cuda()
        plan = D._plan(*shape, 3, 5, sms)
        cplan = D._c_plan(plan)
        out = torch.empty(shape[0] - 1, device="cuda")
        scratch = torch.zeros(max(plan.grid * 8 * 6 * 2, (shape[0] - 1) * plan.n_tiles),
                              dtype=torch.float32, device="cuda")
        ref = D.dfd_series_plain(gray)
        key = "x".join(map(str, shape))
        times, errs = {}, {}
        for name, lib in libs.items():
            def launch(lib=lib):
                err = lib.dfd_series_launch(
                    gray.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                    ctypes.byref(cplan), 1, torch.cuda.current_stream().cuda_stream)
                if err != 0:
                    raise SystemExit(f"dfd_probe: {name} launch failed ({err})")
            if name == "clocks" and (shape != CLOCK_SHAPE or plan.n_tiles != 1):
                continue
            times[name] = chip_smoke.graph_ms(launch) * 1e3
            if name in ("full", "regs2"):
                launch()
                torch.cuda.synchronize()
                errs[name] = float((out - ref).abs().max())
            if name == "clocks":
                scratch.zero_()
                launch()
                torch.cuda.synchronize()
                ctas = scratch.view(torch.int64)[:plan.grid * 8 * 6].view(
                    plan.grid, 8, 6).cpu().numpy()
                rec = ctas[ctas[..., 5] == 1]
                pct = [10, 50, 90, 100]
                result["clocks"] = {
                    "shape": list(shape), "warps": len(rec),
                    "stage_cycles_pct": dict(zip(map(str, pct), np.percentile(
                        rec[:, 2], pct).tolist())),
                    "compute_cycles_pct": dict(zip(map(str, pct), np.percentile(
                        rec[:, 3], pct).tolist())),
                    "warp_cycles_pct": dict(zip(map(str, pct), np.percentile(
                        rec[:, 4], pct).tolist())),
                    # {CTAs on an SM: SMs}
                    "ctas_per_sm": dict(Counter(Counter(
                        ctas[:, 0, 0].tolist()).values())),
                }
        result["us_per_launch"][key] = times
        result["max_abs_err"][key] = errs
    text = json.dumps(result)
    print(text)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
