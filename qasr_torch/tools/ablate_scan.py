"""Where kernel D's step goes, on the card: kernel D (``csrc/qlstm_scan8.cu``)
timed at config 4's shape (B32 x T512, H256, both directions) in bf16 and
f32, whole and with parts of its step removed: the grid barrier, the staging
of h_{t-1}, the products. Each variant is the kernel library built by
``nvcc`` with a patched copy of ``qlstm_scan8.cu`` in place of the source,
under ``qasr_torch/_build/ablate/``; a patch whose line the source no longer
has raises. A variant without a part computes wrong values: only its time
means something.

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
VARIANTS = {
    "whole": [],
    "no barrier": [(SYNC, "__syncthreads();")],
    "no staging": [(STAGE, "")],
    "no products": [(PRODUCTS, "")],
    "no staging, no products": [(STAGE, ""), (PRODUCTS, "")],
}


def _build_variant(i: int, edits: list[tuple[str, str]]) -> str:
    """The kernel library with ``edits`` applied to kernel D's source; returns
    its path."""
    cu, _ = _build.sources()
    with open(os.path.join(_build.CSRC, SCAN_SOURCE)) as f:
        text = f.read()
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"{SCAN_SOURCE} no longer has {old!r}")
        text = text.replace(old, new)
    out = os.path.join(_build.BUILD_DIR, "ablate", str(i))
    os.makedirs(out, exist_ok=True)
    patched = os.path.join(out, SCAN_SOURCE)
    with open(patched, "w") as f:
        f.write(text)
    lib = os.path.join(out, "libqasr_kernels.so")
    _build.compile_library([patched if os.path.basename(c) == SCAN_SOURCE else c for c in cu], lib)
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
    wc32 = torch.stack([
        combine_weights(quaternion_init((4, hid, 4 * hid), generator=torch.Generator().manual_seed(d),
                                        device=dev)) for d in range(2)])
    print(torch.cuda.get_device_name(0), flush=True)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:  # every variant's nvcc runs at once
        paths = list(pool.map(_build_variant, range(len(VARIANTS)), VARIANTS.values()))
    for name, path in zip(VARIANTS, paths):
        lib = _build.open_library(path)
        times = []
        for dtype in (torch.bfloat16, torch.float32):
            xz, wc = xz32.to(dtype), wc32.to(dtype)
            ms = _time_ms(lambda: qlstm_scan.qlstm_scan_cuda(xz, wc, lib=lib))
            times.append(f"{str(dtype)[6:]} {ms:.3f} ms ({ms / t * 1e3:.2f} us a step)")
        print(f"kernel D T{t} B{b} H{hid} D2, {name}: " + ", ".join(times), flush=True)


if __name__ == "__main__":
    main()
