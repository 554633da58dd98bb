"""What bounds the conv's bf16 main loop (``csrc/qconv.cuh``,
``qconv_wg_kernel``) in one scheme, on the card: the rank-8 kernels A (the
forward) and C (its transpose), ``--scheme fast8``, or the 10-product F and
G, ``--scheme fast10`` (the default). The launcher alone on ready weight
combos at the path's shape (B16 F13 T256, 256 -> 256, 3x3), bf16; the
forward without and with the PReLU prologue and bias, the transpose
without and with the PReLU-backward epilogue; whole and with a part of its
loop taken out (the products: the copies, the window pass and the barriers
alone; the copies: the products on stale windows and tiles; the rank-8
combos' multiplies: V8's combos formed as plain sums), and a control
whose wgmma descriptor (``qtile.cuh``) has its two strides swapped, which
must fail its parity check. Each version is kernels A, C, F and G built by
``nvcc`` with patched copies of the headers under
``qasr_torch/_build/ablate_qconv/`` (``tools/_ablate.py``), all builds at
once, and runs in a process of its own, in turns, first to last, then
back. A whole version is first held against the plain versions at a
ragged shape; a version without a part computes wrong values, and only its
time means something. One JSON line a version and run, and each build's
registers and spills.

    python3 -m qasr_torch.tools.ablate_qconv [--scheme fast8|fast10] ["version" ...]
"""

from __future__ import annotations

import json
import sys

import torch

from qasr_torch.ops.kernels.qconv_dx import conj_transpose_w, qconv_dx_cuda, qconv_dx_plain
from qasr_torch.ops.kernels.qconv_ft import SCHEMES, qconv_ft_cuda, qconv_stacked_plain
from qasr_torch.ops.quaternion import combine_weights
from qasr_torch.tools import _ablate

TAP = """      if (G == 0)
        wg.template tap<0>(win, rows_a, r0, ws, w_full + 8 * s, parity, lane);
      else
        wg.template tap<1>(win, rows_a, r0, ws, w_full + 8 * s, parity, lane);
"""
COPIES_ONLY = [("qconv.cuh", TAP, "      mbar_wait(w_full + 8 * s, parity);\n")]
NO_COPIES = [("qconv.cuh", "    mbar_expect_tx(bar, L.xbytes);", "    return;"),
             ("qconv.cuh", "    mbar_expect_tx(w_full + 8 * s, P * kWgWTile);", "    return;"),
             ("qconv.cuh", "      if (kk == 0) mbar_wait(full, parity);\n", ""),
             ("qconv.cuh", "    mbar_wait(win_full + 8 * (c % L.nwin), (c / L.nwin) & 1);\n", "")]
# the rank-8 combos as plain sums (add_bf2), without combo2's two
# multiplies: what forming V8's combos costs the loop (A and C only)
SUMS = [("qtile.cuh", "return combo2(f[term<P>(p, 0)][q], f[term<P>(p, 1)][q], c1, c2);",
         "return add_bf2(f[term<P>(p, 0)][q], f[term<P>(p, 1)][q]);")]
SWAPPED = [("qtile.cuh", "constexpr unsigned kDescLbo = 1;", "constexpr unsigned kDescLbo = 64;"),
           ("qtile.cuh", "constexpr unsigned kDescSbo = 64;", "constexpr unsigned kDescSbo = 1;")]
# version -> edits (file, old, new), and whether the version still computes
# the conv (then its parity is held)
VERSIONS = {
    "whole": ([], True),
    "copies only": (COPIES_ONLY, False),
    "no copies": (NO_COPIES, False),
    "rank-8 combos as sums": (SUMS, False),
    "descriptor strides swapped (a control: its parity must fail)": (SWAPPED, True),
}
# kernels A, C, F and G, C's partial-rows entry, and the error strings
SOURCES = ("qconv_ft10.cu", "qconv_dx10.cu", "qconv_dx8.cu", "qconv_ft8.cu")
ENTRIES = ("qasr_qconv_ft8", "qasr_qconv_dx8", "qasr_qconv_ft10", "qasr_qconv_dx10",
           "qasr_qconv_dx8_partial_rows")
# per scheme: the letters of the forward and the transpose
LETTERS = {"fast8": ("A", "C"), "fast10": ("F", "G")}


def run(name: str, path: str, whole: bool, scheme: str = "fast10") -> None:
    """One version in this process, in ``scheme``: parity (a whole version)
    and times."""
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    lib = _ablate.open_version(path, ENTRIES)
    bf16 = torch.bfloat16
    sc, (fl, tl) = SCHEMES[scheme], LETTERS[scheme]

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    def ready(b, nf, t, cin, cout):
        w = rnd(4, 3, 3, cin, cout, scale=(9 * cin) ** -0.5)
        return (w, rnd(b, 4, nf, t, cin, scale=0.5).to(bf16), rnd(b, 4, nf, t, cout).to(bf16),
                combine_weights(w, bf16, sc.u).contiguous(),
                combine_weights(conj_transpose_w(w), bf16, sc.u).contiguous(),
                rnd(4 * cout, scale=0.1), rnd(4 * cin, scale=0.25).abs(), rnd(4 * cin, scale=0.25))

    if whole:
        # parity at a ragged shape (Cin past a chunk, Cout past a tile, T
        # past a tile), against the plain versions in f32
        w, x, dz, wc_f, wc_g, bias, alpha, slopes = ready(2, 5, 70, 40, 72)
        _ablate.check_parity(f"{name} {fl} B2 F5 T70 40->72 prologue+bias",
                             qconv_ft_cuda(x, wc_f, bias, alpha, scheme=sc, lib=lib),
                             qconv_stacked_plain(x.float(), w, bias, alpha, scheme=sc))
        dx, da = qconv_dx_cuda(dz, wc_g, x, slopes, scheme=sc, lib=lib)
        ref, ref_da = qconv_dx_plain(dz.float(), w, x.float(), slopes, scheme=sc)
        _ablate.check_parity(f"{name} {tl} B2 F5 T70 72->40 epilogue dx", dx, ref)
        _ablate.check_parity(f"{name} {tl} B2 F5 T70 72->40 epilogue dalpha", da, ref_da)
    w, x, dz, wc_f, wc_g, bias, alpha, slopes = ready(16, 13, 256, 256, 256)
    calls = {
        fl: lambda: qconv_ft_cuda(x, wc_f, scheme=sc, lib=lib),
        f"{fl} prologue+bias": lambda: qconv_ft_cuda(x, wc_f, bias, alpha, scheme=sc, lib=lib),
        tl: lambda: qconv_dx_cuda(dz, wc_g, scheme=sc, lib=lib),
        f"{tl} epilogue": lambda: qconv_dx_cuda(dz, wc_g, x, slopes, scheme=sc, lib=lib),
    }
    times = {f"{k} B16 F13 T256 C256": round(_ablate.time_ms(fn, 10), 4) for k, fn in calls.items()}
    print(json.dumps({"version": name, "parity": "ok" if whole else "not held", "ms": times}),
          flush=True)


if __name__ == "__main__":
    args = sys.argv[1:]
    scheme = "fast10"
    if "--scheme" in args:
        i = args.index("--scheme")
        scheme = args[i + 1]
        del args[i:i + 2]
    if scheme not in LETTERS:
        raise ValueError(f"unknown scheme {scheme!r}; known: {list(LETTERS)}")
    if len(args) == 3 and args[0] == "--run":
        run(args[1], args[2], VERSIONS[args[1]][1], scheme)
    else:
        _ablate.main("qasr_torch.tools.ablate_qconv", "ablate_qconv", VERSIONS, SOURCES,
                     "qconv_wg_kernel", args, ("--scheme", scheme))
