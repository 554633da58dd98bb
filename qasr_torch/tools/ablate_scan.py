"""Where the QLSTM recurrence's step goes, on the card: kernel D
(``csrc/qlstm_scan8.cu``, the forward) and kernel E
(``csrc/qlstm_scan8_bwd.cu``, the backward) timed at config 4's shape (B32 x
T512, H256, both directions) in bf16 and f32, whole and with parts of their
step removed. Kernel D: the grid barrier, the staging of h_{t-1}, the
products. Kernel E: the grid barrier, the products over the streamed dprods
(phase C), the stores of its columns of dprods into the exchange buffer.
Each variant is the kernel library built by ``nvcc`` with a patched copy of
the kernel's source in place of it, under ``qasr_torch/_build/ablate/``; a
patch whose line the source no longer has raises. A variant without a part
computes wrong values: only its time means something.

    python3 -m qasr_torch.tools.ablate_scan
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import torch

from qasr_torch.ops.initializers import quaternion_init
from qasr_torch.ops.kernels import _build, qlstm_scan
from qasr_torch.ops.quaternion import combine_weights

SCAN_SOURCE = "qlstm_scan8.cu"
SYNC = "grid.sync();  // hs[t] is complete before any block stages it"
STAGE = "stage_h<T>(h_s, hprev, B, r0, H);"
PRODUCTS = "ScanProduct<T>::run(w_s, h_s, p_s, H, sch);"
BWD_SOURCE = "qlstm_scan8_bwd.cu"
BWD_SYNC = "grid.sync();  // every block's columns of dprods[t] are written"
BWD_PRODUCTS = "BwdProduct<T>::run(w_s, x_s, stage, s_s, xb, B, r0, H);"
BWD_STORES = "store_vec<T>(xb + ((size_t)p * B + b) * h4 + (size_t)g * H + j0, v);"
# (kernel, variant) -> (source, edits)
VARIANTS = {
    ("D", "whole"): (SCAN_SOURCE, []),
    ("D", "no barrier"): (SCAN_SOURCE, [(SYNC, "__syncthreads();")]),
    ("D", "no staging"): (SCAN_SOURCE, [(STAGE, "")]),
    ("D", "no products"): (SCAN_SOURCE, [(PRODUCTS, "")]),
    ("D", "no staging, no products"): (SCAN_SOURCE, [(STAGE, ""), (PRODUCTS, "")]),
    ("E", "whole"): (BWD_SOURCE, []),
    ("E", "no barrier"): (BWD_SOURCE, [(BWD_SYNC, "__syncthreads();")]),
    ("E", "no products"): (BWD_SOURCE, [(BWD_PRODUCTS, "")]),
    ("E", "no exchange stores"): (BWD_SOURCE, [(BWD_STORES, "")]),
    ("E", "no products, no barrier"): (BWD_SOURCE, [(BWD_PRODUCTS, ""),
                                                    (BWD_SYNC, "__syncthreads();")]),
}


def _build_variant(i: int, source: str, edits: list[tuple[str, str]]) -> str:
    """The kernel library with ``edits`` applied to ``source``; returns its
    path."""
    cu, _ = _build.sources()
    with open(os.path.join(_build.CSRC, source)) as f:
        text = f.read()
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"{source} no longer has {old!r}")
        text = text.replace(old, new)
    out = os.path.join(_build.BUILD_DIR, "ablate", str(i))
    os.makedirs(out, exist_ok=True)
    patched = os.path.join(out, source)
    with open(patched, "w") as f:
        f.write(text)
    lib = os.path.join(out, "libqasr_kernels.so")
    _build.compile_library([patched if os.path.basename(c) == source else c for c in cu], lib)
    return lib


def _time_ms(fn, n: int = 20) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("ablate_scan needs a CUDA device")
    dev = torch.device("cuda", 0)
    t, b, hid = 512, 32, 256
    g = torch.Generator(device=dev).manual_seed(0)
    xz32 = torch.randn(t, 2, b, 16 * hid, generator=g, device=dev) * 0.5
    dhs32 = torch.randn(t, 2, b, 4 * hid, generator=g, device=dev)
    wc32 = torch.stack([
        combine_weights(quaternion_init((4, hid, 4 * hid), generator=torch.Generator().manual_seed(d),
                                        device=dev)) for d in range(2)])
    print(torch.cuda.get_device_name(0), flush=True)
    # the backward's inputs: a forward's residuals (the library as built)
    residuals = {}
    for dtype in (torch.bfloat16, torch.float32):
        xz, wc = xz32.to(dtype), wc32.to(dtype)
        with torch.no_grad():
            _, cs, gates = qlstm_scan.qlstm_scan_fwd(xz, wc)
        residuals[dtype] = (wc, gates, cs, dhs32.to(dtype))
    with ThreadPoolExecutor(len(VARIANTS)) as pool:  # every variant's nvcc runs at once
        paths = list(pool.map(_build_variant, range(len(VARIANTS)),
                              *zip(*VARIANTS.values())))
    for (kernel, name), path in zip(VARIANTS, paths):
        lib = _build.open_library(path)
        times = []
        for dtype in (torch.bfloat16, torch.float32):
            if kernel == "D":
                xz, wc = xz32.to(dtype), wc32.to(dtype)
                ms = _time_ms(lambda: qlstm_scan.qlstm_scan_cuda(xz, wc, lib=lib))
            else:
                ms = _time_ms(lambda: qlstm_scan.qlstm_scan_bwd_cuda(*residuals[dtype], lib=lib))
            times.append(f"{str(dtype)[6:]} {ms:.3f} ms ({ms / t * 1e3:.2f} us a step)")
        print(f"kernel {kernel} T{t} B{b} H{hid} D2, {name}: " + ", ".join(times), flush=True)


if __name__ == "__main__":
    main()
