// fqtz_io — native host-side FASTQ scanner of fqsqueezer_tpu_torch (the
// port's copy of native/fqtz_io.cpp, the same functions).
//
// One pass over the file's bytes emits (a) record line offsets and (b)
// padded base-code / quality matrices that the device consumes directly.
// memchr does the newline scan (SIMD in libc); the fill loop is
// parallelized across records with OpenMP. Built with g++ at first use by
// io/native.py; the kernel build globs csrc/*.cu only, so nvcc never sees
// this file.
//
// Exposed via ctypes — plain C ABI, int64/uint8 buffers allocated by the
// Python caller.

#include <cstdint>
#include <cstring>

#if defined(_OPENMP)
#include <omp.h>
#endif

extern "C" {

// Count '\n' bytes in data[0..n). A file with R records has 4R lines.
int64_t fqtz_count_lines(const uint8_t* data, int64_t n) {
    int64_t count = 0;
    const uint8_t* p = data;
    const uint8_t* end = data + n;
    while (p < end) {
        const uint8_t* q = (const uint8_t*)memchr(p, '\n', end - p);
        if (!q) break;
        ++count;
        p = q + 1;
    }
    return count;
}

// Fill line start/end offsets (end excludes '\n' and a preceding '\r').
// starts/ends must hold at least fqtz_count_lines() entries.
// Returns the number of lines written.
int64_t fqtz_scan_lines(const uint8_t* data, int64_t n,
                        int64_t* starts, int64_t* ends) {
    int64_t count = 0;
    const uint8_t* p = data;
    const uint8_t* end = data + n;
    int64_t base = 0;
    while (p < end) {
        const uint8_t* q = (const uint8_t*)memchr(p, '\n', end - p);
        if (!q) break;
        int64_t s = (int64_t)(p - data);
        int64_t e = (int64_t)(q - data);
        if (e > s && data[e - 1] == '\r') --e;
        starts[count] = s;
        ends[count] = e;
        ++count;
        p = q + 1;
    }
    (void)base;
    return count;
}

// Gather R records into padded matrices.
//   seq_starts/seq_ends, qual_starts/qual_ends: [R] line offset pairs.
//   codes: [R*L] uint8 out (A=0 C=1 G=2 T=3 other=4; 0 past length).
//   quals: [R*L] uint8 out (byte-33 clipped to [0,95]; 0 past length).
//   lengths: [R] int32 out.
void fqtz_fill_records(const uint8_t* data,
                       const int64_t* seq_starts, const int64_t* seq_ends,
                       const int64_t* qual_starts, const int64_t* qual_ends,
                       int64_t R, int64_t L,
                       uint8_t* codes, uint8_t* quals, int32_t* lengths) {
    static uint8_t lut[256];
    static bool lut_init = false;
    if (!lut_init) {
        memset(lut, 4, sizeof(lut));
        lut['A'] = 0; lut['C'] = 1; lut['G'] = 2; lut['T'] = 3;
        lut['a'] = 0; lut['c'] = 1; lut['g'] = 2; lut['t'] = 3;
        lut_init = true;
    }
#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
    for (int64_t r = 0; r < R; ++r) {
        int64_t ss = seq_starts[r], se = seq_ends[r];
        int64_t qs = qual_starts[r], qe = qual_ends[r];
        int64_t len = se - ss;
        if (len > L) len = L;
        int64_t qlen = qe - qs;
        if (qlen > len) qlen = len;
        lengths[r] = (int32_t)len;
        uint8_t* crow = codes + r * L;
        uint8_t* qrow = quals + r * L;
        for (int64_t i = 0; i < len; ++i) crow[i] = lut[data[ss + i]];
        memset(crow + len, 0, (size_t)(L - len));
        for (int64_t i = 0; i < qlen; ++i) {
            int v = (int)data[qs + i] - 33;
            if (v < 0) v = 0;
            if (v > 95) v = 95;
            qrow[i] = (uint8_t)v;
        }
        memset(qrow + qlen, 0, (size_t)(L - qlen));
    }
}

// Reconstruct FASTQ bytes from matrices into out (caller-sized).
//   id_buf/id_offsets: concatenated id bytes + [R+1] offsets (no '@'/newline).
// Returns bytes written.
int64_t fqtz_write_records(const uint8_t* codes, const uint8_t* quals,
                           const int32_t* lengths,
                           const uint8_t* id_buf, const int64_t* id_offsets,
                           int64_t R, int64_t L, uint8_t* out) {
    static const char* base_lut = "ACGTN";
    // per-record output offsets (serial prefix sum, then parallel fill)
    int64_t total = 0;
    int64_t* offs = new int64_t[R + 1];
    offs[0] = 0;
    for (int64_t r = 0; r < R; ++r) {
        int64_t idl = id_offsets[r + 1] - id_offsets[r];
        offs[r + 1] = offs[r] + 1 + idl + 1 + lengths[r] + 1 + 2 + lengths[r] + 1;
    }
    total = offs[R];
#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
    for (int64_t r = 0; r < R; ++r) {
        uint8_t* p = out + offs[r];
        int64_t idl = id_offsets[r + 1] - id_offsets[r];
        int64_t len = lengths[r];
        *p++ = '@';
        memcpy(p, id_buf + id_offsets[r], (size_t)idl);
        p += idl;
        *p++ = '\n';
        const uint8_t* crow = codes + r * L;
        for (int64_t i = 0; i < len; ++i) p[i] = (uint8_t)base_lut[crow[i] > 4 ? 4 : crow[i]];
        p += len;
        *p++ = '\n';
        *p++ = '+';
        *p++ = '\n';
        const uint8_t* qrow = quals + r * L;
        for (int64_t i = 0; i < len; ++i) p[i] = (uint8_t)(qrow[i] + 33);
        p += len;
        *p++ = '\n';
    }
    delete[] offs;
    return total;
}

}  // extern "C"
