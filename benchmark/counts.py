"""The benchmark's counts of model work, and the card's published peaks.

Frozen here so that a change to the program cannot change its own
yardstick.  Every count is of the model's work, once, whatever implements
it: a kernel that computes the same model in fewer passes reads the same
count, so a roofline share cannot pass 100% by a change of tier.

- A multiply-accumulate (MAC) is 2 FLOP on the tensor-core peak.  A
  forward is 2 FLOP a MAC; a training step 6 (forward, dx and dW).
- The mlp's MACs a row: d h + (hidden layers) h^2 + h out.  The KAN's:
  sum over layers of din dout (grid + order + 1): the bases and the silu
  branch.
- Activations are a fixed count of fp32 operations on the fp32 peak: 20 a
  sine, snake or tanh unit and pass (forward; the backward's derivative
  another 20), and for the KAN, a (row, input feature) and pass, 5 for the
  silu and the Cox-de-Boor recursion of ``kan_feature_ops``.
- Bytes: the model's inputs read once, its outputs written once, its
  parameters read once (and, in a backward, its gradients written once).
  A population of k windows has k models: its parameters count k times.
- The optimizer's epilogue (clip, Adam and the best snapshot) is counted
  by its bytes a window and step: the gradient, parameters and both
  moments read, the parameters and moments written, and the parameters
  copied to the best snapshot in a step that improved the window's loss.
- The least time is the largest of the three: tensor FLOP over 989 TFLOP/s
  (dense bf16), fp32 FLOP over 67 TFLOP/s, bytes over 3.35 TB/s (NVIDIA
  H100 SXM data sheet, at 700 W).
"""

from __future__ import annotations

import dataclasses

PEAK_TENSOR_FLOP_S = 989e12
PEAK_F32_FLOP_S = 67e12
PEAK_BYTES_S = 3.35e12

SIREN_UNIT_OPS = 20


@dataclasses.dataclass(frozen=True)
class Work:
    tensor_flop: float
    f32_flop: float
    bytes: float

    def least_s(self) -> float:
        return max(self.tensor_flop / PEAK_TENSOR_FLOP_S,
                   self.f32_flop / PEAK_F32_FLOP_S,
                   self.bytes / PEAK_BYTES_S)


def kan_feature_ops(order: int) -> int:
    """fp32 operations of one (row, input feature) of a KAN layer: silu (5)
    and de Boor's local recursion for the order + 1 bases that are not zero
    (5 a term, order (order + 1) / 2 terms; 2 a level for the knot
    differences; 2 to find the interval)."""
    return 5 + 5 * order * (order + 1) // 2 + 2 * order + 2


def layer_dims(cfg: dict) -> list[tuple[int, int]]:
    if cfg["arch"] == "kan":
        sizes = cfg["layers_hidden"]
        return list(zip(sizes[:-1], sizes[1:]))
    h = cfg["hidden_features"]
    hidden = cfg["num_sine"] + cfg["num_snake"] + cfg["num_tanh"]
    return ([(cfg["in_features"], h)] + [(h, h)] * hidden
            + [(h, cfg["out_features"])])


def macs_row(cfg: dict) -> int:
    dims = layer_dims(cfg)
    if cfg["arch"] == "kan":
        j = cfg["grid_size"] + cfg["spline_order"] + 1
        return sum(i * o * j for i, o in dims)
    return sum(i * o for i, o in dims)


def param_floats(cfg: dict) -> int:
    dims = layer_dims(cfg)
    if cfg["arch"] == "kan":
        g, k = cfg["grid_size"], cfg["spline_order"]
        # base_w, spline_w (grid + order), spline_scaler; the knot grid
        return sum(o * i * (g + k + 2) + i * (g + 2 * k + 1)
                   for i, o in dims)
    weights = sum(i * o + o for i, o in dims)
    return weights + cfg["hidden_features"] * cfg["num_snake"]


def act_ops_row(cfg: dict) -> int:
    """fp32 operations of one row's activations in one pass."""
    dims = layer_dims(cfg)
    if cfg["arch"] == "kan":
        return kan_feature_ops(cfg["spline_order"]) * sum(i for i, _ in dims)
    # every layer but the linear head ends in an activation
    return SIREN_UNIT_OPS * sum(o for _, o in dims[:-1])


def _io_bytes(cfg: dict, rows: int) -> int:
    dims = layer_dims(cfg)
    return 4 * rows * (dims[0][0] + dims[-1][1])


def forward_work(cfg: dict, rows: int) -> Work:
    """The model over ``rows`` rows: the stack kernel, or kernel G."""
    return Work(2 * macs_row(cfg) * rows, act_ops_row(cfg) * rows,
                _io_bytes(cfg, rows) + 4 * param_floats(cfg))


def sweep_work(cfg: dict, rows: int, windows: int = 1) -> Work:
    """Kernel D's sweep over ``rows`` rows (of all ``windows`` models): the
    forward, the cotangent and dx (4 FLOP a MAC), the activations and their
    derivatives; it reads the coordinates, the targets and the
    parameters."""
    return Work(4 * macs_row(cfg) * rows, 2 * act_ops_row(cfg) * rows,
                _io_bytes(cfg, rows) + 4 * windows * param_floats(cfg))


def epilogue_work(cfg: dict, window_steps: int, improved: int) -> Work:
    """Clip, Adam and the best snapshot over ``window_steps`` (window, step)
    pairs, ``improved`` of which wrote the snapshot: 7 floats an element
    (g, p, mu, nu read; p, mu, nu written), 1 more where improved."""
    return Work(0, 0, 4 * param_floats(cfg) * (7 * window_steps + improved))


def backward_work(cfg: dict, rows: int) -> Work:
    """Kernel H over ``rows`` rows: dx and dW (4 FLOP a MAC) and the
    derivatives of the activations; it reads the inputs, the cotangent and
    the parameters and writes the gradients."""
    return Work(4 * macs_row(cfg) * rows, act_ops_row(cfg) * rows,
                _io_bytes(cfg, rows) + 8 * param_floats(cfg))


def train_step_flop(cfg: dict, rows: int) -> int:
    """A training step's model FLOP (MACs only), for ``*mfu``."""
    return 6 * macs_row(cfg) * rows


def forward_flop(cfg: dict, rows: int) -> int:
    """A forward's model FLOP (MACs only), for ``*mfu``."""
    return 2 * macs_row(cfg) * rows
