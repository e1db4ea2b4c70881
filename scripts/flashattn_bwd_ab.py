"""Check and time K6's two backward kernels alone, without the model: the
tensor-core ``csrc/flashattn_bwd_tc.cu`` and the CUDA-core
``csrc/flashattn_bwd.cu``, each forced with ``kernel=``, at the
internlm2-1.8b train step's layer shape (B 2, S 4096, 16 query heads over
8 KV heads, hd 128, causal), at gemma3-4b's local-layer shape (B 1, S 2048,
8 over 4 heads, hd 256, window 1024) and at hd 64 (the step's shape with
hd 64).

    python scripts/flashattn_bwd_ab.py [--seed S] [--shapes train_layer,...]

For each shape: seeded bf16 inputs (q and k of unit RMS, as qk-norm gives;
v and the output gradient standard normal), the tensor-core forward's out
and lse, then ``chip_smoke.bwd_kernel_check`` (both variants and the plain
backward within ``fp32_bound.attention_grads_f64``'s bf16 tolerance, the
broken plain variants outside it, two runs of each kernel bit-identical,
fp32 copies within the fp32 bound) and ``chip_smoke.bwd_times`` (both
kernels, the plain version and sdpa's backward, back to back, and the
bound). Prints the card and the kernels' ``ptxas`` lines first, one line a
shape, and one JSON line last. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
SHAPES = {
    "train_layer": dict(B=2, S=4096, Hq=16, Hkv=8, hd=128, window=-1),
    "gemma_local": None,  # chip_smoke.TR_GEMMA_LOCAL
    "hd64": dict(B=2, S=4096, Hq=16, Hkv=8, hd=64, window=-1),
}


def inputs(shape, gen, dev):
    """bf16 q, k, v, dout of ``shape``: q and k at unit RMS a row."""
    x = [torch.randn((shape["B"], shape["S"], h, shape["hd"]), generator=gen, device=dev)
         for h in (shape["Hq"], shape["Hkv"], shape["Hkv"], shape["Hq"])]
    for i in (0, 1):
        x[i] = x[i] / x[i].square().mean(-1, keepdim=True).sqrt()
    return [t.bfloat16() for t in x]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--shapes", default=",".join(SHAPES))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flashattn_bwd_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    dev = torch.device("cuda")
    rt = cs.Port()
    rt.build.lib()
    name = None
    for line in rt.build.ptxas_report.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and "bwd" in name and ("Used" in line or "spill" in line):
            cs.log(f"ptxas {name}: {line.split(':', 1)[-1].strip()}")
    out = {"card": smi.splitlines()[0], "shapes": {}}
    for key in args.shapes.split(","):
        shape = SHAPES[key] or cs.TR_GEMMA_LOCAL
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        q, k, v, dout = inputs(shape, gen, dev)
        o, lse = rt.fa_forward(q, k, v, shape["window"], None)
        t0 = time.perf_counter()
        check = cs.bwd_kernel_check(rt, key, q, k, v, o, lse, dout, shape["window"], gen)
        times = cs.bwd_times(rt, q, k, v, o, lse, dout, shape["window"])
        times.update(tflops={kern: times["flops"] / times[f"{kern}_ms"] / 1e9
                             for kern in ("tensor_core", "cuda_core")},
                     bf16_peak_share=times["flops"] / times["tensor_core_ms"] / 1e9
                     / (cs.BF16_FLOPS / 1e12))
        cs.log(f"{key} {shape}: {json.dumps(times)} ({time.perf_counter() - t0:.1f} s)")
        out["shapes"][key] = dict(shape=shape, check=check, times=times)
        del q, k, v, dout, o, lse
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
