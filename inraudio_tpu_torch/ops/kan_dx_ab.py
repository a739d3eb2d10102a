"""Where the tensor-core dx's time goes, on one card: layer 1 of the runner
KAN at grid 100 / order 3 (256 -> 256 over the 7 s clip's 308,207 rows, J
= 104, the wide build of kan.cu, bf16x3), and the same layer with 32
input features (W's planes 3.4 MB, in L2 whatever the order the CTAs read
them), timed through ``kan_dx_tc`` with parts of ``kan_dx_tc_kernel``
switched off.

    python3 inraudio_tpu_torch/ops/kan_dx_ab.py

Writes a copy of csrc/kan.cu into the build directory with switches
(``-DNO_MMA``: no product; ``-DNO_CONTRACT``: the contraction warps
skip their work; ``-DNO_W``: no W staging after the first units), builds
each variant with ``-DKAN_WIDE=1`` (one nvcc each, all started together)
and times the kernel with each (CUDA events; outputs of the switched-off
variants are not results).  Prints one ``kan_dx_ab {...}`` JSON line.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import threading

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
CSRC = os.path.join(ROOT, "inraudio_tpu_torch", "csrc")

VARIANTS = {"route": (), "no_mma": ("-DNO_MMA",),
            "no_contract": ("-DNO_CONTRACT",), "no_w": ("-DNO_W",),
            "none": ("-DNO_MMA", "-DNO_CONTRACT", "-DNO_W")}


def variant_source() -> str:
    """csrc/kan.cu with the switches, in csrc/build/kan_dx_ab/ beside
    copies of the headers; returns its path relative to csrc/."""
    with open(os.path.join(CSRC, "kan.cu")) as f:
        src = f.read()

    def rep(old, new):
        nonlocal src
        if src.count(old) != 1:
            raise RuntimeError(f"kan.cu changed; no single {old!r}")
        src = src.replace(old, new)

    rep("        load_next();\n        const bf16* wh",
        "#ifdef NO_W\n        cp_async_commit();\n#else\n"
        "        load_next();\n#endif\n        const bf16* wh")
    rep("        for (int ks = 0; ks < width; ks += 32) {\n",
        "#ifdef NO_MMA\n        if (false)\n#endif\n"
        "        for (int ks = 0; ks < width; ks += 32) {\n")
    rep("        for (int p = ct; p < TM * nf; p += kDxCtThreads) {\n",
        "#ifdef NO_CONTRACT\n        if (false)\n#endif\n"
        "        for (int p = ct; p < TM * nf; p += kDxCtThreads) {\n")
    out = os.path.join(CSRC, "build", "kan_dx_ab")
    os.makedirs(out, exist_ok=True)
    for h in ("mma_common.cuh", "siren_common.cuh"):
        shutil.copy(os.path.join(CSRC, h), out)
    with open(os.path.join(out, "kan_dx_ab.cu"), "w") as f:
        f.write(src)
    return os.path.join("build", "kan_dx_ab", "kan_dx_ab.cu")


def main() -> int:
    sys.path.insert(0, ROOT)
    import torch

    from inraudio_tpu_torch.ops import kan_fused as kf

    src = variant_source()
    libs = {name: kf._KanLibrary("kan_dx_ab", ("-DKAN_WIDE=1",) + flags, src)
            for name, flags in VARIANTS.items()}
    errors = []

    def build(name):
        try:
            libs[name]()
        except Exception as e:  # reported below
            errors.append(f"{name}: {e}")

    threads = [threading.Thread(target=build, args=(n,)) for n in VARIANTS]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise RuntimeError("\n".join(errors))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(7)
    n, dout, order, nk = 308_207, 256, 3, 107
    J = nk - order
    mode = "bf16x3"
    code = kf._MODE_CODE[mode]
    stream = torch.cuda.current_stream().cuda_stream
    result = {"card": card, "ms": {}}

    def ms(fn, iters=5):
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / iters

    # the runner's layer 1, and 32 input features
    for din in (256, 32):
        x = torch.rand(n, din, device=dev, generator=gen) * 2.2 - 1.1
        grid = torch.linspace(-1.06, 1.06, nk, device=dev).repeat(din, 1)
        w_t = torch.randn(dout, din * J, device=dev, generator=gen) * 0.05
        g = torch.randn(n, dout, device=dev, generator=gen) / n
        s = kf.LayerShape(n, din, dout, nk, J)
        plan = kf.dw_plan(n, din, dout, J, mode, s.ks, True)
        xp = kf.dx_plan(din, dout, J, mode, s.ks)
        result[f"plan din{din}"] = [xp.tm, xp.fc, xp.inner]
        for name in list(VARIANTS) + ["route"]:
            lib = libs[name]()
            ghi, glo = kf.split_g(lib, g, s, plan, stream)
            whi, wlo = kf.split_w_bf16(lib, w_t, s, ghi.shape[1], code,
                                       stream)
            dx = torch.empty(n, din, device=dev)

            def call():
                if lib.kan_dx_tc(
                        x.data_ptr(), grid.data_ptr(), ghi.data_ptr(),
                        glo.data_ptr(), whi.data_ptr(), wlo.data_ptr(),
                        ghi.shape[1], dx.data_ptr(), n, din, dout, nk,
                        order, code, xp.tm, xp.fc, xp.inner, stream):
                    raise RuntimeError(f"{name}: kan_dx_tc failed")

            t = ms(call)
            result["ms"].setdefault(f"{name} din{din}", []).append(t)
            print(f"{name} din {din}: {t:.3f} ms", flush=True)
    print("kan_dx_ab " + json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
