"""Kernel H of each KAN layer split into its launches, timed on one card.

``launch_split`` runs one layer's H (``kan_fused.layer_backward``) on a
library whose every C entry is bracketed by CUDA events on the current
stream, and returns the layer's time and each entry's (the splits of g
and W, the dW pass, the fixed-order reduce, the dx kernel): ms a call,
summed over an entry's launches in the call.  ``chip_smoke.py`` phase 29
calls it on the checkout's tree.  Run alone it times a tree's H at the
runner KAN's widths over the synthetic clip's 308,207 rows, at grid
extension's configs (the wide build of ``csrc/kan.cu``), bf16x3:

    python3 inraudio_tpu_torch/ops/kan_h_split.py ROOT

imports ``inraudio_tpu_torch`` from the tree at ROOT (a parent commit
unpacked beside the checkout with ``git archive``, or ``.``) and prints
one JSON line a config after the card's name and power limit.

    python3 inraudio_tpu_torch/ops/kan_h_split.py ROOT --runner

times the runner KAN's H instead (grid 5 / order 3, the default build),
layer by layer at 308,207 and 441,000 rows (the benchmark's 10 s clip),
on the route and on ``one_role_library`` (kan.cu built with
``-DKAN_BWD_WS=0``: the fused pass the builder warps replaced, the
parent's kernel), interleaved one-role, route, route, one-role, their dW
and dx compared bit for bit; then layer 1 at 441,000 rows on VARIANTS of
the route (8 builder warps in place of 4; the products or the builders'
work switched off; every quotient by '/'; and clock64 counters: a
builder warp's clocks a (row, feature) pair and its wait for the
products, the product warps' clocks in GX, in dW and waiting for the
builders); then the wide build's layer 1 at WIDE_J64 over 308,207 rows,
route against one-role.  One JSON line.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys
import threading

# the runner KAN's widths, the synthetic clip's rows, phase 29's configs
LAYERS = (1, 256, 256, 1)
ROWS = 308_207
CONFIGS = ((20, 3), (5, 5), (100, 3), (5, 8))
# --runner: the 7 s clip's rows and the benchmark's 10 s clip's; the wide
# build's configs whose layer 1 takes the fused pass (J <= 64)
RUNNER_ROWS = (ROWS, 441_000)
WIDE_J64 = ((20, 3), (5, 5), (5, 8))
CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")

_ONE_ROLE: dict = {}


def one_role_library(wide: bool = False):
    """kan.cu (the default build, or the wide one) built with
    ``-DKAN_BWD_WS=0``: H's tensor-core pass with dx fused on one role of
    warps (kan_bwd_tc_kernel with DX, each chunk's GX, build and dW in
    series), which kan_bwd_ws_kernel replaced; for A/Bs beside the route
    (the card tests, ``--runner``)."""
    if wide not in _ONE_ROLE:
        from inraudio_tpu_torch.ops import kan_fused as kf
        _ONE_ROLE[wide] = kf._KanLibrary(
            "kan_wide_one_role" if wide else "kan_one_role",
            (("-DKAN_WIDE=1",) if wide else ()) + ("-DKAN_BWD_WS=0",))
    return _ONE_ROLE[wide]


# clock64 counters of kan_bwd_ws_kernel's roles (-DAB_CLOCK), added by lane
# 0 of each warp: [0] a builder warp's clocks over its pairs, [1] its pairs
# (lane 0's: the most a lane has), [2] its clocks waiting for the products'
# buffers, [3] a product warp's clocks waiting for A^T, [4] its clocks in
# GX, [5] in dW
_CLOCK = r"""
#ifdef AB_CLOCK
__device__ unsigned long long ab_clk[6];
#define AB_ADD(k, v) \
  if ((threadIdx.x & 31) == 0) atomicAdd(&ab_clk[k], (unsigned long long)(v))
#else
#define AB_ADD(k, v)
#endif
"""


def variant_source() -> str:
    """csrc/kan.cu with kan_bwd_ws_kernel's switches, in
    csrc/build/kan_h_ab/ beside copies of the headers; returns its path
    relative to csrc/.  ``AB_BUILD_WARPS``: the builder warps (4, or 8
    with the registers split 200 / 56); ``AB_CLOCK``: the clock64
    counters; ``AB_NO_MMA``: no product; ``AB_NO_BUILD``: no (row,
    feature) formed; ``AB_IEEE``: every quotient by '/'."""
    with open(os.path.join(CSRC, "kan.cu")) as f:
        src = f.read()

    def rep(old, new):
        nonlocal src
        if src.count(old) != 1:
            raise RuntimeError(f"kan.cu changed; no single {old!r}")
        src = src.replace(old, new)

    rep("constexpr int kWsBuildWarps = 4;\n",
        "#ifndef AB_BUILD_WARPS\n#define AB_BUILD_WARPS 4\n#endif\n"
        "constexpr int kWsBuildWarps = AB_BUILD_WARPS;\n")
    rep("constexpr int kWsMmaRegs = 216;\nconstexpr int kWsBuildRegs = 72;\n",
        "constexpr int kWsMmaRegs = kWsBuildWarps == 8 ? 200 : 216;\n"
        "constexpr int kWsBuildRegs = kWsBuildWarps == 8 ? 56 : 72;\n")
    rep("constexpr int kMaxBases = 16;", _CLOCK + "constexpr int kMaxBases = 16;")
    rep("      mbar_wait(a_empty + b, use ^ 1);",
        "      const long long ab_t0 = clock64();\n"
        "      mbar_wait(a_empty + b, use ^ 1);")
    rep("      short* pv = prev + b * slots;\n",
        "      short* pv = prev + b * slots;\n"
        "      const long long ab_t1 = clock64();\n"
        "      AB_ADD(2, ab_t1 - ab_t0);\n"
        "      AB_ADD(1, (nf - bw + kWsBuildWarps - 1) / kWsBuildWarps);\n")
    rep("      __syncwarp();\n      if ((bt & 31) == 0) mbar_arrive(gx_empty + b);",
        "      AB_ADD(0, clock64() - ab_t1);\n"
        "      __syncwarp();\n      if ((bt & 31) == 0) mbar_arrive(gx_empty + b);")
    rep("      mbar_wait(a_full + b, (cp / kWsBufs) & 1);\n",
        "      const long long ab_t2 = clock64();\n"
        "      mbar_wait(a_full + b, (cp / kWsBufs) & 1);\n"
        "      const long long ab_t3 = clock64();\n"
        "      AB_ADD(3, ab_t3 - ab_t2);\n")
    rep("      __syncwarp();\n      if (lane == 0) mbar_arrive(a_empty + b);\n",
        "      AB_ADD(5, clock64() - ab_t3);\n"
        "      __syncwarp();\n      if (lane == 0) mbar_arrive(a_empty + b);\n")
    rep("    if (c < chunks) {  // GX = g @ W^T for chunk c's rows and the "
        "tile's K\n",
        "    if (c < chunks) {  // GX = g @ W^T for chunk c's rows and the "
        "tile's K\n      const long long ab_t4 = clock64();\n")
    rep("      // park it once the builders are done with chunk c - 2's GX there\n",
        "      AB_ADD(4, clock64() - ab_t4);\n"
        "      // park it once the builders are done with chunk c - 2's GX there\n")
    # NO_MMA: no product (ldmatrix or mma) in GX or dW; NO_BUILD: no
    # (row, feature) built, the silu slot zeroed
    rep("#pragma unroll 4\n      for (int k = 0; k < TN; k += 16) {\n",
        "#ifdef AB_NO_MMA\n      if (false)\n#endif\n"
        "#pragma unroll 4\n      for (int k = 0; k < TN; k += 16) {\n")
    rep("      if (live) {\n        // one k16 step",
        "#ifdef AB_NO_MMA\n      if (false) {\n#else\n      if (live) {\n"
        "#endif\n        // one k16 step")
    # IEEE: every quotient by '/' (the branch-free ones discarded)
    rep("          bool good = den_ok(den);\n",
        "          bool good = den_ok(den);\n#ifdef AB_IEEE\n"
        "          good = false;\n#endif\n")
    rep("        int i = -1;\n        if (r < nr) {\n",
        "        int i = -1;\n#ifdef AB_NO_BUILD\n        if (false) {\n"
        "#else\n        if (r < nr) {\n#endif\n")
    rep('extern "C" {\n', 'extern "C" {\n'
        "#ifdef AB_CLOCK\n"
        "// the counters into out (6 values), then zero\n"
        "int ab_clock(void* out) {\n"
        "  unsigned long long zero[6] = {0, 0, 0, 0, 0, 0};\n"
        "  if (int e = (int)cudaMemcpyFromSymbol(out, ab_clk, sizeof(zero))) "
        "return e;\n"
        "  return (int)cudaMemcpyToSymbol(ab_clk, zero, sizeof(zero));\n}\n"
        "#endif\n")
    out = os.path.join(CSRC, "build", "kan_h_ab")
    os.makedirs(out, exist_ok=True)
    for h in ("mma_common.cuh", "siren_common.cuh"):
        shutil.copy(os.path.join(CSRC, h), out)
    with open(os.path.join(out, "kan_h_ab.cu"), "w") as f:
        f.write(src)
    return os.path.join("build", "kan_h_ab", "kan_h_ab.cu")


# the route's variants (--runner): builder warps, clock counters
VARIANTS = {"builders8": ("-DAB_BUILD_WARPS=8",), "clock": ("-DAB_CLOCK",),
            "no_products": ("-DAB_NO_MMA",), "no_build": ("-DAB_NO_BUILD",),
            "ieee": ("-DAB_IEEE",)}


class _TimedLibrary:
    """A kan.cu library whose C entries record a CUDA event pair around
    each call: ``events`` holds (entry, start, end)."""

    def __init__(self, torch, lib):
        self._torch, self._lib, self.events = torch, lib, []

    def __getattr__(self, name):
        fn = getattr(self._lib, name)

        def call(*args):
            start = self._torch.cuda.Event(enable_timing=True)
            end = self._torch.cuda.Event(enable_timing=True)
            start.record()
            rc = fn(*args)
            end.record()
            self.events.append((name, start, end))
            return rc

        return call


def launch_split(torch, kf, lib, x, grid, g, w_t, s, order, mode, need_dx,
                 iters=3):
    """One layer's H timed whole and launch by launch, ``iters`` calls
    after a warm-up: (ms a call, {entry: (launches a call, ms a call)})."""
    stream = torch.cuda.current_stream().cuda_stream
    kf.layer_backward(lib, x, grid, g, w_t, s, order, mode, stream, need_dx)
    torch.cuda.synchronize()
    timed = _TimedLibrary(torch, lib)
    calls = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        kf.layer_backward(timed, x, grid, g, w_t, s, order, mode, stream,
                          need_dx)
        end.record()
        calls.append((start, end))
    torch.cuda.synchronize()
    total = sum(a.elapsed_time(b) for a, b in calls) / iters
    parts: dict[str, list] = {}
    for name, a, b in timed.events:
        p = parts.setdefault(name, [0, 0.0])
        p[0] += 1
        p[1] += a.elapsed_time(b)
    return total, {k: (n // iters, ms / iters) for k, (n, ms) in
                   parts.items()}


def stack_split(torch, kf, layers, xs, order, mode, iters=3):
    """``launch_split`` of every layer of a stack, each on the cotangent
    ones / n of its width (phase 29's): [(layer, din, dout, ms, parts)]."""
    out = []
    for li, (grid, w_t) in enumerate(layers):
        x = xs[li]
        s = kf._layer_shape(x, grid, w_t, order, li)
        g = torch.ones((s.n, s.dout), device=x.device) / s.n
        lib = kf.kan_library(order, s.nk)()
        ms, parts = launch_split(torch, kf, lib, x, grid, g, w_t, s, order,
                                 mode, li > 0, iters)
        out.append((li, s.din, s.dout, ms, parts))
        del g
    return out


def runner_libraries(kf) -> dict:
    """The route's library, ``one_role_library`` and the route's VARIANTS,
    one nvcc each, all started together."""
    src = variant_source()
    libs = {"route": kf.KAN_LIBRARY, "one_role": one_role_library()}
    libs.update({k: kf._KanLibrary("kan_h_ab", v, src)
                 for k, v in VARIANTS.items()})
    errors = []

    def build(key):
        try:
            libs[key]()
        except Exception as e:  # reported below
            errors.append(f"{key}: {e}")

    threads = [threading.Thread(target=build, args=(k,)) for k in libs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise RuntimeError("\n".join(errors))
    return {k: lib() for k, lib in libs.items()}


def runner(torch, kf, dev, iters=3) -> dict:
    """``--runner``: the runner KAN's H layer by layer at RUNNER_ROWS rows,
    route against one-role (interleaved, bit-equal), then layer 1 at the
    last row count on the variants."""
    from inraudio_tpu_torch.models import KANConfig, build_model
    libs = runner_libraries(kf)
    mode, order = kf.kan_dot_mode(), 3
    cfg = KANConfig(layers_hidden=LAYERS, grid_size=5, spline_order=order)
    params = build_model("kan", cfg, fused=True).init(
        torch.Generator().manual_seed(0), dev)
    flat = [t.detach().contiguous() for t in kf.flatten_kan_params(params)]
    layers = list(zip(flat[0::2], flat[1::2]))
    stream = torch.cuda.current_stream().cuda_stream
    out = {"mode": mode, "rows": {}}
    for n in RUNNER_ROWS:
        coords = torch.linspace(-1, 1, n, device=dev)[:, None]
        _, xs = kf.KAN_FWD(layers, coords, order, mode)
        per = []
        for li, (grid, w_t) in enumerate(layers):
            x = xs[li]
            s = kf._layer_shape(x, grid, w_t, order, li)
            g = torch.randn((n, s.dout), device=dev, generator=torch.Generator(
                dev).manual_seed(li)) / n
            args = (x, grid, g, w_t, s, order, mode)
            runs = {"one_role": [], "route": []}
            for tag in ("one_role", "route", "route", "one_role"):
                runs[tag].append(launch_split(torch, kf, libs[tag], *args,
                                              li > 0, iters))
            a = kf.layer_backward(libs["route"], *args, stream, li > 0)
            b = kf.layer_backward(libs["one_role"], *args, stream, li > 0)
            torch.cuda.synchronize()
            equal = all(torch.equal(p.view(torch.int32), q.view(torch.int32))
                        for p, q in zip(a, b) if p is not None)
            per.append(dict(layer=li, din=s.din, dout=s.dout,
                            **{tag: [ms for ms, _ in r]
                               for tag, r in runs.items()},
                            launches={tag: r[0][1] for tag, r in runs.items()},
                            bit_equal=equal))
            del g, a, b
        out["rows"][n] = per
        if n != RUNNER_ROWS[-1]:
            del xs
    # layer 1 at the last row count on the route's VARIANTS, in turn both
    # ways, and the clock64 counters over one call
    grid, w_t = layers[1]
    x = xs[1]
    s = kf._layer_shape(x, grid, w_t, order, 1)
    g = torch.randn((s.n, s.dout), device=dev,
                    generator=torch.Generator(dev).manual_seed(1)) / s.n
    args = (x, grid, g, w_t, s, order, mode)
    runs = {tag: [] for tag in ("route", *VARIANTS)}
    for tag in ("route", *VARIANTS, *reversed(VARIANTS), "route"):
        runs[tag].append(launch_split(torch, kf, libs[tag], *args, True,
                                      iters)[1]["kan_bwd_tc"][1])
    plan = kf.dw_plan(s.n, s.din, s.dout, s.J, mode, s.ks, s.wide)
    chunks = -(-s.din // plan.fck) * sum(
        -(-min(plan.rows_per_slice, s.n - z * plan.rows_per_slice) // 32)
        for z in range(plan.slices))
    lib, warps = libs["clock"], 4
    lib.ab_clock.argtypes = [ctypes.c_void_p]
    counts = (ctypes.c_ulonglong * 6)()
    kf.layer_backward(lib, *args, stream, True)
    torch.cuda.synchronize()
    lib.ab_clock(ctypes.addressof(counts))
    kf.layer_backward(lib, *args, stream, True)
    torch.cuda.synchronize()
    if lib.ab_clock(ctypes.addressof(counts)):
        raise RuntimeError("ab_clock failed")
    busy, pairs, wait, pwait, gx, dw = (int(v) for v in counts)
    clocks = dict(
        builder_warps=warps, pair_clk=busy / max(pairs, 1),
        builder_busy_clk_a_chunk=busy / (chunks * warps),
        builder_wait_clk_a_chunk=wait / (chunks * warps),
        product_wait_clk_a_chunk=pwait / (chunks * 8),
        product_gx_clk_a_chunk=gx / (chunks * 8),
        product_dw_clk_a_chunk=dw / (chunks * 8))
    out["layer1_variants"] = dict(rows=s.n, chunks=chunks, ms=runs,
                                  clocks=clocks)
    del xs, g, args
    # the wide build's layer 1 at J <= 64 over the 7 s clip's rows: the
    # route against the one-role pass built wide
    out["wide"] = {}
    for grid_size, worder in WIDE_J64:
        cfg = KANConfig(layers_hidden=LAYERS, grid_size=grid_size,
                        spline_order=worder)
        wp = build_model("kan", cfg, fused=True).init(
            torch.Generator().manual_seed(0), dev)
        wf = [t.detach().contiguous() for t in kf.flatten_kan_params(wp)]
        wl = list(zip(wf[0::2], wf[1::2]))
        coords = torch.linspace(-1, 1, ROWS, device=dev)[:, None]
        _, wxs = kf.KAN_FWD(wl, coords, worder, mode)
        grid, w_t = wl[1]
        s = kf._layer_shape(wxs[1], grid, w_t, worder, 1)
        g = torch.randn((s.n, s.dout), device=dev,
                        generator=torch.Generator(dev).manual_seed(1)) / s.n
        args = (wxs[1], grid, g, w_t, s, worder, mode)
        wlibs = {"route": kf.kan_library(worder, s.nk)(),
                 "one_role": one_role_library(True)()}
        runs = {"one_role": [], "route": []}
        for tag in ("one_role", "route", "route", "one_role"):
            runs[tag].append(launch_split(torch, kf, wlibs[tag], *args, True,
                                          iters)[1]["kan_bwd_tc"][1])
        a = kf.layer_backward(wlibs["route"], *args, stream, True)
        b = kf.layer_backward(wlibs["one_role"], *args, stream, True)
        torch.cuda.synchronize()
        runs["bit_equal"] = all(
            torch.equal(p.view(torch.int32), q.view(torch.int32))
            for p, q in zip(a, b))
        out["wide"][f"g{grid_size}o{worder}"] = runs
        del wxs, g, args, a, b
    return out


def main(root: str, mode_flag: str = "") -> int:
    sys.path.insert(0, root)
    import torch

    from inraudio_tpu_torch.models import KANConfig, build_model
    from inraudio_tpu_torch.ops import kan_fused as kf

    if not torch.cuda.is_available():
        print("needs an NVIDIA card: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"nvidia-smi: {smi}; tree {root}")
    dev = torch.device("cuda")
    if mode_flag == "--runner":
        res = runner(torch, kf, dev)
        res["sm_clock"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
        print("kan_h_runner " + json.dumps(res))
        return 0
    kf.KAN_WIDE_LIBRARY()
    coords = torch.linspace(-1, 1, ROWS, device=dev)[:, None]
    mode = kf.kan_dot_mode()
    for grid_size, order in CONFIGS:
        cfg = KANConfig(layers_hidden=LAYERS, grid_size=grid_size,
                        spline_order=order)
        params = build_model("kan", cfg, fused=True).init(
            torch.Generator().manual_seed(0), dev)
        flat = [t.detach().contiguous()
                for t in kf.flatten_kan_params(params)]
        layers = list(zip(flat[0::2], flat[1::2]))
        _, xs = kf.KAN_FWD(layers, coords, order, mode)
        rows = stack_split(torch, kf, layers, xs, order, mode)
        print(json.dumps({"config": f"g{grid_size}o{order}", "mode": mode,
                          "rows": ROWS, "layers": [
                              {"layer": li, "din": di, "dout": do,
                               "ms": ms, "launches": parts}
                              for li, di, do, ms, parts in rows]}))
        del xs, layers, flat, params
    return 0


if __name__ == "__main__":
    if len(sys.argv) not in (2, 3) or sys.argv[2:] not in ([], ["--runner"]):
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(*sys.argv[1:]))
