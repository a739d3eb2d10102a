"""Bit-for-bit A/B of the CUDA kernels' results between two trees of the
repository, on one card.

``save ROOT OUT`` imports ``inraudio_tpu_torch`` from the tree at ROOT,
runs the results listed below on the card from fixed seeds, and saves them
to OUT (``torch.save``); ``compare A B`` loads two such files, compares the
results both hold and lists those that are not bit-equal (exit code 1 if
any) and those only one holds (a tree older or newer than the list).  Run
it on a parent commit unpacked beside the checkout (``git archive``) and on
the change, on the same card:

    python3 inraudio_tpu_torch/ops/kernel_ab.py save PARENT parent.pt
    python3 inraudio_tpu_torch/ops/kernel_ab.py save . change.pt
    python3 inraudio_tpu_torch/ops/kernel_ab.py compare parent.pt change.pt

The results (112), each at the kernel widths h = 32, 64, 128, 256 where it
has an h: the stack kernel's output (3 windows x 700 rows, approx_sin) in
the default bf16x3 tier, in the highest tier and in the decode's bf16 and
mixed (bf16 / bf16x2) degree-7 tiers; C's gradients (bf16x2 and highest
grad tiers, a random cotangent), D's state (params, mu, nu, best) and loss
after 3 steps; E's buffer (grads and loss) for the first window's initial
state on a shard of its 700 rows with a row limit of 500 and a clip of 900
valid rows (bf16x2 and highest); D's params after 2 steps of an RFF model
(h = 256, 256 frequencies, 5000 rows); the optimizer epilogue alone
(``adam_results``: F's state after one call at clip 0 and 1.0 with the loss
below and above best_loss, D's epilogue on fixed grads at k = 3 at clip 0
and 1.0); for KAN([1, 64, 64, 1]) and
KAN([2, 32, 3]) over 3000 rows: G's output in the bf16x3 and highest
tiers, G's bf16x3 output of each layer alone on a fixed input of its
width, and H's dW per layer (highest tier); for KAN([1, 64, 64, 1]) at
grid 20 / order 3, grid 100 / order 3 and grid 5 / order 8 (the wide
build of kan.cu), H of each layer alone (``layer_backward`` on a fixed
input and cotangent of its widths, 3000 rows) in the bf16x3 and highest
tiers: its dW, and the dx of layers 1 and 2 (the head's from the narrow
H); and G of each layer alone on the bf16x3 inputs (the wide build's
tensor-core G at layers 0 and 1, the narrow G at the head); for the
runner KAN's layer 1 alone (256 -> 256, grid 5 / order 3, 4000 rows, a
fixed input and cotangent) H's dW and dx in the bf16, bf16x2 and bf16x3
tiers (the fused tensor-core pass, builder warps beside product
warps), and the same of the runner KAN's head alone (256 -> 1, the
narrow H, ``H-head-<tier>``).  The bf16-tier C, D and E results follow
the grad kernel's route, G's bf16x3 results of a layer with dout >= 8 (and so both stacks' bf16x3
outputs) the tensor-core G's, and the stack's bf16x3 outputs
(``stack{h}``) its tensor-core route.  H's,
every highest-tier result (``stack-highest{h}``: the stack's FMA kernel),
the stack's bf16 and mixed outputs (``stack-bf16{h}``, ``stack-mixed{h}``:
the tensor-core kernel runs those tiers' products as the FMA kernel's
chains) and G's bf16x3 output of a layer with dout < 8 (the narrow G,
tile_gemm's chains) are the ones that must stay bit-equal across those
changes.  Of the wide KAN results, only a dx that moved to the
tensor-core dx kernel (layer 1's at grid 100 in bf16x3: J > 64) may
differ from a tree that formed it on the FMA kernel; the narrow H's dW and
dx, and every dW, stay bit-equal.  The wide tensor-core G's outputs follow
its plan's chunk of features (the k16 blocks each output is summed over),
the narrow G's stay bit-equal.
"""

from __future__ import annotations

import sys


def save(root: str, dest: str) -> int:
    sys.path.insert(0, root)
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from inraudio_tpu_torch.models import (KANConfig, SirenSnakeTanhConfig,
                                           build_model, rff_init)
    from inraudio_tpu_torch.ops import kan_fused as kf
    from inraudio_tpu_torch.ops import siren_fused as sf
    from inraudio_tpu_torch.ops import siren_step as ss
    from inraudio_tpu_torch.ops import siren_train as st
    from inraudio_tpu_torch.ops._nvcc import build_library
    from inraudio_tpu_torch.train import loop as tloop

    # the tree's four libraries, one nvcc each, all started together
    builds = [(name, [name + ".cu"], ()) for name in
              ("siren_stack", "siren_train", "kan")]
    builds.append(("kan_wide", ["kan.cu"], ("-DKAN_WIDE=1",)))
    with ThreadPoolExecutor(len(builds)) as pool:
        list(pool.map(lambda b: build_library(*b), builds))
    dev = torch.device("cuda")
    out = {}
    for h in (32, 64, 128, 256):
        cfg = SirenSnakeTanhConfig(hidden_features=h, first_omega_0=300.0)
        params = build_model("mlp", cfg).init(
            torch.Generator().manual_seed(h), dev, windows=3)
        coords = torch.linspace(-1, 1, 700, device=dev)[:, None]
        out[f"stack{h}"] = sf.fused_siren_apply_stacked(params, cfg, coords,
                                                        approx_sin=True)
        out[f"stack-highest{h}"] = sf.fused_siren_apply_stacked(
            params, cfg, coords, approx_sin=True, f32_mode="highest")
        out[f"stack-bf16{h}"] = sf.fused_siren_apply_stacked(
            params, cfg, coords, approx_sin=True, sin_poly_degree=7,
            compute_dtype=torch.bfloat16)
        out[f"stack-mixed{h}"] = sf.fused_siren_apply_stacked(
            params, cfg, coords, approx_sin=True, sin_poly_degree=7,
            mixed_matmul=True, f32_mode="bf16x2")
        plan = sf.stack_plan(cfg, approx_sin=True)
        cot = torch.randn(3, 700, 1, device=dev,
                          generator=torch.Generator(dev).manual_seed(1))
        out[f"bwd{h}"] = st.flatten_params(
            st.SIREN_BWD(params, cfg, plan, "bf16x2", coords, cot), cfg)
        out[f"bwd-highest{h}"] = st.flatten_params(
            st.SIREN_BWD(params, cfg, plan, "highest", coords, cot), cfg)
        model = build_model("mlp", cfg, fused=True, approx_sin=True)
        tc = tloop.TrainConfig(learning_rate=1e-3, grad_clip_norm=1.0)
        state = tloop.init_train_state(model, torch.Generator().manual_seed(h),
                                       tc, dev, windows=3)
        fs = ss.flat_state_from_train_state(state, cfg)
        step = ss.make_fused_mse_train_step(cfg, tc, 700, approx_sin=True)
        tgt = 0.5 * torch.sin(7 * coords[:, 0])[None].repeat(3, 1)
        limit = torch.tensor([500], dtype=torch.int32, device=dev)
        for gmode in ("bf16x2", "highest"):
            out[f"E-{gmode}{h}"] = ss.SIREN_GRAD(
                fs.params[:1].contiguous(), coords, tgt[:1], limit, 900, cfg,
                plan, gmode)
        for _ in range(3):
            fs, (loss, _) = step(fs, coords, tgt)
        out[f"step{h}"] = torch.cat([fs.params, fs.mu, fs.nu,
                                     fs.best_params], 1)
        out[f"loss{h}"] = loss
    cfg = SirenSnakeTanhConfig(in_features=512, hidden_features=256,
                               first_omega_0=300.0)
    b = rff_init(torch.Generator().manual_seed(5), 1, 256, sigma=10.0,
                 device=dev)
    model = build_model("mlp", cfg, fused=True, approx_sin=True, rff_b=b)
    tc = tloop.TrainConfig(learning_rate=1e-3)
    state = tloop.init_train_state(model, torch.Generator().manual_seed(5),
                                   tc, dev, windows=1)
    fs = ss.flat_state_from_train_state(state, cfg)
    step = ss.make_fused_mse_train_step(cfg, tc, 5000, approx_sin=True,
                                        rff_b=b)
    c = torch.linspace(-1, 1, 5000, device=dev)[:, None]
    for _ in range(2):
        fs, _ = step(fs, c, 0.3 * torch.sin(40 * c[:, 0])[None])
    out["rff_step256"] = fs.params
    out.update(adam_results(torch, ss, st, dev))
    for lh in ((1, 64, 64, 1), (2, 32, 3)):
        p = build_model("kan", KANConfig(layers_hidden=lh)).init(
            torch.Generator().manual_seed(0), dev)
        flat = [t.detach().contiguous() for t in kf.flatten_kan_params(p)]
        layers = list(zip(flat[0::2], flat[1::2]))
        x = torch.rand(3000, lh[0], device=dev,
                       generator=torch.Generator(dev).manual_seed(2)) * 2 - 1
        out[f"G{lh}"], _ = kf.KAN_FWD(layers, x, 3, "bf16x3")
        out[f"G-highest{lh}"], _ = kf.KAN_FWD(layers, x, 3, "highest")
        gen = torch.Generator(dev).manual_seed(4)
        for i, layer in enumerate(layers):
            xi = torch.rand(3000, layer[0].shape[0], device=dev,
                            generator=gen) * 2.2 - 1.1
            out[f"G-layer{lh}-{i}"], _ = kf.KAN_FWD([layer], xi, 3, "bf16x3")
        g = torch.randn(3000, lh[-1], device=dev,
                        generator=torch.Generator(dev).manual_seed(3)) / 3000
        _, xs = kf.KAN_FWD(layers, x, 3, "highest")
        for i, t in enumerate(kf.KAN_BWD(layers, xs, g, 3, "highest")):
            out[f"H-highest{lh}-{i}"] = t
    out.update(wide_kan_results(torch, kf, build_model, KANConfig, dev))
    out.update(runner_h_results(torch, kf, build_model, KANConfig, dev))
    torch.cuda.synchronize()
    torch.save({k: v.cpu() for k, v in out.items()}, dest)
    print(f"saved {len(out)} results of {root} to {dest}")
    return 0


def wide_kan_results(torch, kf, build_model, KANConfig, dev) -> dict:
    """H of each layer of KAN([1, 64, 64, 1]) alone at grid 20 / order 3,
    grid 100 / order 3 and grid 5 / order 8, in the bf16x3 and highest
    tiers, on fixed inputs and cotangents: dW of every layer, dx of layers
    1 and 2; and G of each layer on the bf16x3 inputs."""
    out = {}
    stream = torch.cuda.current_stream().cuda_stream
    for grid_size, order in ((20, 3), (100, 3), (5, 8)):
        cfg = KANConfig(layers_hidden=(1, 64, 64, 1), grid_size=grid_size,
                        spline_order=order)
        p = build_model("kan", cfg).init(torch.Generator().manual_seed(1),
                                          dev)
        flat = [t.detach().contiguous() for t in kf.flatten_kan_params(p)]
        gen = torch.Generator(dev).manual_seed(6)
        for mode in ("bf16x3", "highest"):
            for li, (grid, w_t) in enumerate(zip(flat[0::2], flat[1::2])):
                x = torch.rand(3000, grid.shape[0], device=dev,
                               generator=gen) * 2.2 - 1.1
                g = torch.randn(3000, w_t.shape[0], device=dev,
                                generator=gen) / 3000
                s = kf._layer_shape(x, grid, w_t, order, li)
                lib = kf.kan_library(order, s.nk)()
                dw, dx = kf.layer_backward(lib, x, grid, g, w_t, s, order,
                                           mode, stream, need_dx=li > 0)
                tag = f"H-g{grid_size}o{order}-{mode}-layer{li}"
                out[tag + "-dW"] = dw
                if dx is not None:
                    out[tag + "-dx"] = dx
                if mode == "bf16x3":
                    out[f"G-g{grid_size}o{order}-{mode}-layer{li}"], _ = \
                        kf.KAN_FWD([(grid, w_t)], x, order, mode)
    return out


def runner_h_results(torch, kf, build_model, KANConfig, dev) -> dict:
    """H of the runner KAN's layer 1 alone (256 -> 256, grid 5 / order 3)
    and of its head alone (256 -> 1) over 4000 rows of a fixed input and
    cotangent, with dx, in the bf16, bf16x2 and bf16x3 tiers: their dW and
    dx."""
    out = {}
    stream = torch.cuda.current_stream().cuda_stream
    for tag, dout, seed in (("runner", 256, 8), ("head", 1, 10)):
        p = build_model("kan", KANConfig(layers_hidden=(256, dout))).init(
            torch.Generator().manual_seed(seed), dev)
        grid, w_t = [t.detach().contiguous()
                     for t in kf.flatten_kan_params(p)]
        gen = torch.Generator(dev).manual_seed(seed + 1)
        x = torch.rand(4000, 256, device=dev, generator=gen) * 2.2 - 1.1
        g = torch.randn(4000, dout, device=dev, generator=gen) / 4000
        s = kf._layer_shape(x, grid, w_t, 3, 1)
        lib = kf.kan_library(3, s.nk)()
        for mode in ("bf16", "bf16x2", "bf16x3"):
            dw, dx = kf.layer_backward(lib, x, grid, g, w_t, s, 3, mode,
                                       stream, need_dx=True)
            out[f"H-{tag}-{mode}-dW"], out[f"H-{tag}-{mode}-dx"] = dw, dx
    return out


def adam_results(torch, ss, st, dev) -> dict:
    """The optimizer epilogue alone, on fixed random states: F
    (``SIREN_ADAM``) on one runner-sized model (P = 264,452) at clip 0 and
    1.0 with the loss below and above best_loss; D's epilogue on the
    reduce's output for k = 3 headline-sized windows (P = 66,692, two loss
    slices each) with their own lr, c1, loss and best_loss, one window's
    norm below the clip of 1.0 and two above, at clip 0 and 1.0.  D's
    epilogue is called through ``launch_adam`` where the tree has it, else
    through the older ``siren_adam`` entry, which had no scale scratch and
    no span count."""
    gen = torch.Generator(dev).manual_seed(11)
    rnd = lambda *shape: torch.randn(*shape, device=dev,  # noqa: E731
                                     generator=gen)
    vec = lambda *v: torch.tensor(v, device=dev)  # noqa: E731
    out = {}
    P = 264_452
    p0, mu0, nu0, best0 = (0.1 * rnd(1, P), 1e-3 * rnd(1, P),
                           1e-6 * rnd(1, P) ** 2, 0.1 * rnd(1, P))
    buf = torch.zeros(P + 4, device=dev)
    buf[:P] = 3.0 * rnd(P) / P ** 0.5
    for clip in (0.0, 1.0):
        for label, loss in (("below", 0.25), ("above", 0.75)):
            buf[P] = loss
            p, mu, nu, best = (t.clone() for t in (p0, mu0, nu0, best0))
            lo = ss.SIREN_ADAM(p, mu, nu, best, buf, vec(1e-3), vec(0.271),
                               vec(2.997e-3), vec(0.5), clip)
            out[f"F-clip{clip}-{label}"] = torch.cat([p, mu, nu, best,
                                                      lo[None]], 1)
    k, P, slices = 3, 66_692, 2
    lib = st.TRAIN_LIBRARY()
    stream = torch.cuda.current_stream().cuda_stream
    norms = vec(3.0, 0.4, 1.7)
    partial = (rnd(k, slices, P) * (norms / P ** 0.5 / 2)[:, None, None]
               ).reshape(k * slices, P)
    loss_part = vec(0.1, 0.2, 0.4, 0.5, 0.05, 0.05)
    grads = torch.empty(k, P, device=dev)
    sq_part = torch.empty(k, -(-P // st.CHUNK_FLOATS), device=dev)
    rc = lib.siren_reduce(partial.data_ptr(), grads.data_ptr(),
                          sq_part.data_ptr(), 0, 0, k, slices, P, stream)
    assert rc == 0, rc
    p0, mu0, nu0, best0 = (0.1 * rnd(k, P), 1e-3 * rnd(k, P),
                           1e-6 * rnd(k, P) ** 2, 0.1 * rnd(k, P))
    lr, c1 = vec(1e-3, 2e-3, 5e-4), vec(0.1, 0.19, 0.271)
    c2, best_loss = vec(1e-3, 1.999e-3, 2.997e-3), vec(0.5, 0.6, 0.2)
    for clip in (0.0, 1.0):
        p, mu, nu, best = (t.clone() for t in (p0, mu0, nu0, best0))
        loss = torch.empty(k, device=dev)
        if hasattr(ss, "launch_adam"):
            ss.launch_adam(lib, grads, sq_part, loss_part, p, mu, nu, best,
                           loss, torch.empty(k, device=dev), lr, c1, c2,
                           best_loss, clip, stream)
        else:
            rc = lib.siren_adam(
                grads.data_ptr(), sq_part.data_ptr(), loss_part.data_ptr(),
                p.data_ptr(), mu.data_ptr(), nu.data_ptr(), best.data_ptr(),
                loss.data_ptr(), lr.data_ptr(), c1.data_ptr(), c2.data_ptr(),
                best_loss.data_ptr(), k, slices, P, clip, stream)
            assert rc == 0, rc
        out[f"D-epilogue-clip{clip}"] = torch.cat([p, mu, nu, best,
                                                   loss[:, None]], 1)
    return out


def compare(a_path: str, b_path: str) -> int:
    import torch

    a, b = torch.load(a_path), torch.load(b_path)
    both = [k for k in a if k in b]
    differ = [k for k in both if not torch.equal(a[k], b[k])]
    for k in both:
        print(f"{k}: {tuple(a[k].shape)} "
              f"{'bit-equal' if k not in differ else 'DIFFERS'}")
    for path, only in ((a_path, sorted(a.keys() - b.keys())),
                       (b_path, sorted(b.keys() - a.keys()))):
        if only:
            print(f"only in {path}: {only}")
    print(f"compared {len(both)} results; not bit-equal: {differ}")
    return 1 if differ else 0


if __name__ == "__main__":
    args = sys.argv[1:]
    if len(args) == 3 and args[0] == "save":
        sys.exit(save(args[1], args[2]))
    if len(args) == 3 and args[0] == "compare":
        sys.exit(compare(args[1], args[2]))
    print(__doc__, file=sys.stderr)
    sys.exit(2)
