"""Time the flash forward kernel with one and with two shared-memory stages
of k and v tiles, on the card:

    python -m ps_pytorch_tpu_torch.tools.flash_fwd_stages [--shape 64,2048,64]

``csrc/flash_attention.cu`` takes the forward's stage count from the input
type (one for f32, two for bf16, as the backward) unless
``PSK_FLASH_FWD_STAGES`` is defined when it is built. This builds the source
twice more, with 1 and with 2 (both nvcc at once, into ``build/``), loads
each with ctypes, holds each build's forward against the plain version
(2e-5 in f32, 2e-2 in bf16) and times it at the shape (causal) in turns, 1,
2, 2, 1, by CUDA events. It prints one ``STAGES`` line per type and the
card's name and power limit. Without a CUDA device it fails.
"""

import argparse
import ctypes
import subprocess
import sys

import torch

from ps_pytorch_tpu_torch.ops import _build
from ps_pytorch_tpu_torch.ops import flash_attention as fa
from ps_pytorch_tpu_torch.tools.profile_capture import card_line


def build_variants(counts=(1, 2)) -> dict:
    """{stages: loaded library} for each count, built in parallel."""
    _build.BUILD.mkdir(parents=True, exist_ok=True)
    src = _build.CSRC / "flash_attention.cu"
    procs = {}
    for n in counts:
        out = _build.BUILD / f"flash_attention-fwd-stages{n}.so"
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS,
               f"-DPSK_FLASH_FWD_STAGES={n}", "-o", str(out), str(src)]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True), out)
    libs = {}
    for n, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc with {n} stages failed:\n{log}")
        libs[n] = ctypes.CDLL(str(out))
        fa._configure(libs[n])
    return libs


def time_ms(fn, iters: int) -> float:
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shape", default="64,2048,64",
                    help="BH,S,D of the causal forward (the LM's by default)")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_fwd_stages needs a CUDA device", file=sys.stderr)
        return 1
    bh, s, d = (int(x) for x in args.shape.split(","))
    libs = build_variants()
    gen = torch.Generator(device="cuda").manual_seed(0)
    scale = d ** -0.5
    for dtype, suffix, tol in ((torch.float32, "f32", 2e-5),
                               (torch.bfloat16, "bf16", 2e-2)):
        q, k, v = (torch.randn(bh, s, d, device="cuda", generator=gen)
                   .to(dtype) for _ in range(3))
        o_ref, lse_ref = fa.flash_attention_reference(q, k, v, True, scale)
        o, lse = torch.empty_like(q), torch.empty_like(lse_ref)
        times = {n: [] for n in libs}
        for n in (1, 2, 2, 1):
            fn = getattr(libs[n], f"psk_flash_fwd_{suffix}")

            def call():
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         o.data_ptr(), lse.data_ptr(), bh, s, d, 1, scale,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"flash fwd ({n} stages) launch "
                                       f"failed: CUDA error {err}")

            call()
            torch.cuda.synchronize()
            for got, want in ((o, o_ref), (lse, lse_ref)):
                if not torch.allclose(got.float(), want.float(), rtol=tol,
                                      atol=tol):
                    raise RuntimeError(
                        f"flash fwd {suffix} with {n} stages differs from "
                        f"the plain version by "
                        f"{(got.float() - want.float()).abs().max().item()}")
            times[n].append(time_ms(call, args.iters))
        print(f"STAGES flash_fwd {suffix} {bh}x{s}x{d} causal: " + "; ".join(
            f"{n} stage{'s' if n > 1 else ''} ms "
            f"{', '.join(f'{t:.4f}' for t in ts)}"
            for n, ts in sorted(times.items())), flush=True)
    print(f"CARD {card_line()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
