"""Where the QLSTM recurrence's step goes, on the card: kernel D
(``csrc/qlstm_scan8.cu``, the forward) and kernel E
(``csrc/qlstm_scan8_bwd.cu``, the backward), the launchers alone at config
4's shape (B32 x T512, H256, both directions, ragged lengths), bf16, whole
and with parts of their step taken out:

- D: the direction barrier; the exchange (the bulk copies of the combos of
  h_{t-1}, their waits, and the stores of the combos of h_t); the products;
  the loads of xz and the stores of hs, cs and gates; all but the barrier.
- E: the direction barrier; the products (with their partials' stores);
  the loads of the other blocks' partials; both (no exchange); the loads of
  gates, cs and dhs and the stores of dz; all but the barrier.

Each version is the two kernels built by ``nvcc`` with patched copies of
the sources under ``qasr_torch/_build/ablate_scan/`` (``tools/_ablate.py``),
all builds at once, each run in a process of its own, the versions in turns,
first to last, then back. The whole version is first held against the plain
versions at a ragged shape (B40 spans two row tiles, H48 the products'
partial warps); a version without a part computes wrong values, and only its
time means something. One JSON line a version and run, and each build's
registers and spills.

    python3 -m qasr_torch.tools.ablate_scan ["version" ...]
"""

from __future__ import annotations

import json
import sys

import torch

from qasr_torch.ops.initializers import quaternion_init
from qasr_torch.ops.kernels import qlstm_scan
from qasr_torch.ops.quaternion import combine_weights
from qasr_torch.tools import _ablate

D_SRC, E_SRC = "qlstm_scan8.cu", "qlstm_scan8_bwd.cu"
D_BARRIER = [(D_SRC, "if (t + 1 < Tn) dir_barrier(bar + d, ++n_bar * (unsigned)per_dir);",
              "if (t + 1 < Tn) __syncthreads();")]
D_EXCHANGE = [(D_SRC, "if (t > 0 && threadIdx.x == 0) issue_copies(x_s, src, bar0, B, r0, ldx);",
               ""),
              (D_SRC, "          wait_copies(bar0, parity);\n", ""),
              (D_SRC, "V::store(dst + (size_t)p * B * ldx, v);", "")]
D_PRODUCTS = [(D_SRC, "product_bf16(acc, w_s, x_s, H);", "")]
D_IO = [(D_SRC, "raw[g] = *reinterpret_cast<const unsigned*>(xz + row * h16 + g * h4 + lane);",
         "raw[g] = 0u;"),
        (D_SRC, "    V::store(hs + row * h4 + lane, h);\n    V::store(cs + row * h4 + lane, c);\n"
                "#pragma unroll\n    for (int g = 0; g < 4; ++g) V::store(gates + row * h16 + g * h4"
                " + lane, gt[g]);\n", "")]
E_BARRIER = [(E_SRC, "if (t > 0) dir_barrier(bar + d, ++n_bar * (unsigned)per_dir);",
              "if (t > 0) __syncthreads();")]
E_PRODUCTS = [(E_SRC, "products<T>(w_s, a_s, rec_dst, B, r0, H, sch);", "")]
E_PARTIALS = [(E_SRC, "if (k0 + u < per_dir) ldcg_f(src + (size_t)(k0 + u) * slab, v[u]);",
               "if (k0 + u < per_dir) for (int e = 0; e < kC; ++e) v[u][e] = 0.0f;")]
E_IO = [(E_SRC, "  if (b >= B) return;\n  const size_t row", "  return;\n  const size_t row"),
        (E_SRC, "#pragma unroll\n    for (int g = 0; g < 4; ++g) V::store(p + g * h4, v[g]);\n",
         "")]
# version -> edits (file, old, new), and whether the version still computes
# the recurrence (then its parity is held)
VERSIONS = {
    "whole": ([], True),
    "D no barrier": (D_BARRIER, False),
    "D no exchange": (D_EXCHANGE, False),
    "D no products": (D_PRODUCTS, False),
    "D no loads or stores": (D_IO, False),
    "D barrier alone": (D_EXCHANGE + D_PRODUCTS + D_IO, False),
    "E no barrier": (E_BARRIER, False),
    "E no products": (E_PRODUCTS, False),
    "E no partial loads": (E_PARTIALS, False),
    "E no exchange": (E_PRODUCTS + E_PARTIALS, False),
    "E no loads or stores": (E_IO, False),
    "E barrier alone": (E_PRODUCTS + E_PARTIALS + E_IO, False),
}
# the sources each version builds: kernels D and E, and the error strings
SOURCES = (D_SRC, E_SRC, "qconv_ft8.cu")


def _inputs(dev, t, b, hid, seed):
    """xz (gate-major), wc8, dhs and ragged lengths in bf16 on the card."""
    g = torch.Generator(device=dev).manual_seed(seed)
    lens = torch.randint(t // 4 + 1, t + 1, (b,), generator=g, device=dev)
    lens[0] = t
    xz = (torch.randn(t, 2, b, 16 * hid, generator=g, device=dev) * 0.5).to(torch.bfloat16)
    dhs = torch.randn(t, 2, b, 4 * hid, generator=g, device=dev).to(torch.bfloat16)
    wc = torch.stack([combine_weights(quaternion_init(
        (4, hid, 4 * hid), generator=torch.Generator().manual_seed(seed + d), device=dev))
        for d in range(2)]).to(torch.bfloat16)
    return xz, wc, dhs, lens


def run(name: str, path: str, whole: bool) -> None:
    """One version in this process: parity (the whole version) and times."""
    dev = torch.device("cuda", 0)
    lib = _ablate.open_version(path, ("qasr_qlstm_scan8", "qasr_qlstm_scan8_bwd"))
    if whole:
        xz, wc, dhs, lens = _inputs(dev, 9, 40, 48, 1)
        got = qlstm_scan.qlstm_scan_cuda(xz, wc, lens, lib=lib)
        again = qlstm_scan.qlstm_scan_cuda(xz, wc, lens, lib=lib)
        want = qlstm_scan.qlstm_scan_fwd_plain(xz, wc, lens)
        for what, a, b_, w in zip(("hs", "cs", "gates"), got, again, want):
            if not torch.equal(a, b_):
                raise RuntimeError(f"{name}: kernel D's {what} differs between two runs")
            _ablate.check_parity(f"{name} D {what} B40 T9 H48", a, w)
        _, cs, gates = want
        dz = qlstm_scan.qlstm_scan_bwd_cuda(wc, gates, cs, dhs, lens, lib=lib)
        if not torch.equal(dz, qlstm_scan.qlstm_scan_bwd_cuda(wc, gates, cs, dhs, lens, lib=lib)):
            raise RuntimeError(f"{name}: kernel E differs between two runs")
        _ablate.check_parity(f"{name} E dz B40 T9 H48", dz,
                             qlstm_scan.qlstm_scan_bwd_plain(wc, gates, cs, dhs, lens))
    t, b, hid = 512, 32, 256
    xz, wc, dhs, lens = _inputs(dev, t, b, hid, 0)
    _, cs, gates = qlstm_scan.qlstm_scan_fwd_plain(xz, wc, lens)  # E's inputs, from no kernel
    d_ms = _ablate.time_ms(lambda: qlstm_scan.qlstm_scan_cuda(xz, wc, lens, lib=lib), 20)
    e_ms = _ablate.time_ms(lambda: qlstm_scan.qlstm_scan_bwd_cuda(wc, gates, cs, dhs, lens,
                                                                   lib=lib), 20)
    print(json.dumps({"version": name, "parity": "ok" if whole else "not held",
                      "ms": {"D": round(d_ms, 4), "E": round(e_ms, 4)},
                      "us a step": {"D": round(d_ms / t * 1e3, 3),
                                    "E": round(e_ms / t * 1e3, 3)}}), flush=True)


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--run":
        run(sys.argv[2], sys.argv[3], VERSIONS[sys.argv[2]][1])
    else:
        _ablate.main("qasr_torch.tools.ablate_scan", "ablate_scan", VERSIONS, SOURCES,
                     "qlstm_scan8", sys.argv[1:])
