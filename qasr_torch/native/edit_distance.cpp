// Native batch Levenshtein / PER scorer for qasr.
//
// The reference scores PER in Python (edit distance over decoded phone
// sequences; SURVEY.md §2a C9). Decoding large eval sets makes the scorer a
// host-side hot path, so qasr ships it as a C++ component (this environment
// has no Rust toolchain; C++ per the build contract), loaded via ctypes —
// qasr/decode/scoring.py keeps a pure-numpy fallback.
//
// Build: qasr/native/__init__.py invokes g++ -O3 -shared -fPIC on demand.

#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" {

// Levenshtein distance between int sequences a[0..n), b[0..m).
int qasr_edit_distance(const int32_t* a, int n, const int32_t* b, int m) {
    if (n == 0) return m;
    if (m == 0) return n;
    std::vector<int32_t> prev(m + 1), cur(m + 1);
    for (int j = 0; j <= m; ++j) prev[j] = j;
    for (int i = 1; i <= n; ++i) {
        cur[0] = i;
        const int32_t ai = a[i - 1];
        for (int j = 1; j <= m; ++j) {
            const int32_t cost = (ai == b[j - 1]) ? 0 : 1;
            cur[j] = std::min({prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost});
        }
        std::swap(prev, cur);
    }
    return prev[m];
}

// Batch PER accumulation over padded id matrices.
//   refs: [batch, ref_stride], hyps: [batch, hyp_stride]
// Writes total edit errors and total reference tokens.
void qasr_batch_per(const int32_t* refs, const int32_t* ref_lens,
                    const int32_t* hyps, const int32_t* hyp_lens, int batch,
                    int ref_stride, int hyp_stride, int64_t* out_errs,
                    int64_t* out_total) {
    int64_t errs = 0, total = 0;
    for (int i = 0; i < batch; ++i) {
        const int n = ref_lens[i];
        const int m = hyp_lens[i];
        errs += qasr_edit_distance(refs + (int64_t)i * ref_stride, n,
                                   hyps + (int64_t)i * hyp_stride, m);
        total += n;
    }
    *out_errs = errs;
    *out_total = total;
}

}  // extern "C"
