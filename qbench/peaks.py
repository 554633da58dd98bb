"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; dense rates,
no sparsity, at the 700 W power limit): every share of peak and roofline
the benchmark reports is taken against these."""

#: bf16 on the tensor cores, FLOP/s
BF16_FLOPS = 989e12
#: HBM3 bandwidth, bytes/s
HBM_BYTES = 3.35e12
