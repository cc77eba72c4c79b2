"""The yardstick of the smoother kernels: their least bytes and the card's
peaks.

``min_bytes`` is a frozen copy of the port's
``afivo_streamer_tpu_torch/ops/smoother.min_bytes`` (each input value a
kernel reads counted once, its output written once), so that a later
change of the program cannot change what a kernel is held to. The peaks
are NVIDIA's data sheet of the H100 SXM at its full power limit of 700 W;
a share of them is stated with the card's power limit beside it.
"""

from __future__ import annotations

import re

#: HBM3 bandwidth of one H100 SXM (bytes per second)
HBM_BYTES_PER_S = 3.35e12
#: peak rates outside the tensor cores (operations per second)
PEAK_FLOPS = {"float64": 34e12, "float32": 67e12}
#: the published power limit the peaks assume (W)
PEAK_POWER_W = 700.0

#: the smoother's wrappers (the program's ``ops/smoother`` names) and the
#: family of kernels each launches
WRAPPERS = {"fill_sweep_2d": "2d", "sweep_2d": "2d", "fill_2d": "2d",
            "fill_2d_swap": "2d", "sweep_3d": "3d", "fill_3d": "3d"}
#: the CUDA kernels of each family, as the device trace names them
KERNELS = {"2d": ("fill_sweep_2d_kernel", "sweep_2d_kernel",
                  "sweep_2d_big_kernel", "fill_2d_kernel"),
           "3d": ("sweep_3d_kernel", "fill_3d_kernel",
                  "fill_3d_direct_kernel")}
_KERNEL_FAMILY = {k: fam for fam, ks in KERNELS.items() for k in ks}
_IDENT = re.compile(r"[A-Za-z_]\w*")


def _head(trace_name: str) -> str:
    """A demangled signature without its argument list."""
    return trace_name.replace("(anonymous namespace)::", "").split("(")[0]


def kernel_family(trace_name: str):
    """The family ('2d' or '3d') of a device operation named
    ``trace_name`` (a demangled signature such as ``void
    sweep_2d_kernel<double>(...)``), or None for any other operation."""
    for ident in _IDENT.findall(_head(trace_name)):
        if ident in _KERNEL_FAMILY:
            return _KERNEL_FAMILY[ident]
    return None


def min_bytes(name: str, n: int, nc: int, itemsize: int = 8) -> int:
    """Least bytes kernel ``name`` moves on n boxes of nc^ndim cells: each
    input value it reads read once and the output written once. A fill
    (K1's too) reads no side or face ghost of the input, which it
    overwrites; W counts only the columns the kernel reads (3 of 8, 5 with
    the parity-swap terms), g only the columns it reads (the own row for a
    sweep, all for a fill); the mask is float32 and g int32 whatever the
    state's ``itemsize`` is."""
    ndim = 3 if name.endswith("_3d") else 2
    nd, C = 2 * ndim, nc + 2
    ghosts = n * nd * nc ** (ndim - 1)  # the side or face ghosts
    phi_in, floats = n * C ** ndim, n * C ** ndim  # phi3 in, new blocks out
    g_cols, mask = 1, 0
    if name.startswith("fill"):
        phi_in -= ghosts
        floats += ghosts  # A
        floats += n * nd * (5 if name == "fill_2d_swap" else 3)  # W
        g_cols = 1 + nd
    if "sweep" in name:
        floats += n * (1 + 2 + nd) * nc ** ndim  # R and cs
        mask = 4 * nc ** ndim
    return (phi_in + floats) * itemsize + 4 * n * g_cols + mask


def bound_seconds(launches) -> float:
    """The least time of the launches ``[(wrapper, n, nc, itemsize)]`` at
    the card's memory rate (every kernel here is bound by its bytes: at
    most 0.3 operations per byte against the peaks' 10 and more)."""
    return sum(min_bytes(name, n, nc, item)
               for name, n, nc, item in launches) / HBM_BYTES_PER_S


def share_pct(launches, kernel_seconds: float):
    """100 x the launches' least time over the device time their kernels
    took; None where no kernel time was seen."""
    if not launches or kernel_seconds <= 0.0:
        return None
    return 100.0 * bound_seconds(launches) / kernel_seconds
