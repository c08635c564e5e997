// The port's own copy of `phase2_bn254_tpu/native/codec.cpp` (imports changed
// only); file:line citations of `.rs` files are to the upstream Rust repository.
// Native host codec engine: file bytes <-> 16-bit limb digit arrays.
//
// This is the host-runtime side of the point codecs (the analog of the
// reference's serialization hot path inside its mmap'ed batch loop,
// powersoftau/src/batched_accumulator.rs:767-1111 and the
// ec.rs EncodedPoint codecs ec.rs:763-946): big-endian canonical coordinate
// bytes with flag bits in the top byte, converted to/from the little-endian
// 16-bit digit planes the device kernels consume.  numpy needs several
// widening temporaries per conversion (~10 s per 2^21 G1 region on the
// 4-core host); this single-pass C++ does the same work in tens of ms.
//
// C ABI only (loaded via ctypes).  All functions are generic over the
// digit count `nw` (BN254 Fq: nw=16, BLS12-381 Fq: nw=24).

#include <cstdint>
#include <cstddef>
#include <cstring>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// ---------------------------------------------------------------------------
// decode: raw elements -> digit planes + flags, with validation
// ---------------------------------------------------------------------------
//
// Layout: each of the `n` elements is `ncoords * 2*nw` bytes, the
// concatenation of `ncoords` big-endian coordinates in FILE order.  Flag
// bits live in byte 0 of the element: 0x80 = "y greatest" (compressed),
// 0x40 = point at infinity.
//
// Outputs:
//   digits_out   n * ncoords * nw uint32 (little-endian 16-bit digits,
//                coordinate-major in file order)
//   greatest_out n uint8 (0/1)
//   inf_out      n uint8 (0/1); only written when reject_inf == 0
//
// Validation (first failing element index goes to *bad_index):
//   ret 1: infinity flag set while reject_inf
//   ret 2: greatest flag set while reject_greatest (uncompressed formats)
//   ret 3: a coordinate is >= the field modulus (check_lt_q)
//
// qbytes is the 2*nw-byte big-endian modulus.  Elements flagged infinity
// (when allowed) skip the range check and decode as all-zero digits, which
// matches the reference's empty-payload infinity encoding.
int p2_decode_digits(const uint8_t* raw, int64_t n, int ncoords, int nw,
                     const uint8_t* qbytes, int check_lt_q, int reject_inf,
                     int reject_greatest, uint32_t* digits_out,
                     uint8_t* greatest_out, uint8_t* inf_out,
                     int64_t* bad_index) {
    const int coord_bytes = 2 * nw;
    const int esize = ncoords * coord_bytes;
    int err = 0;
    int64_t bad = -1;

#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; i++) {
        const uint8_t* e = raw + i * esize;
        uint8_t flags = e[0];
        uint8_t greatest = (flags & 0x80) ? 1 : 0;
        uint8_t inf = (flags & 0x40) ? 1 : 0;
        int my_err = 0;
        if (inf && reject_inf) my_err = 1;
        if (!my_err && greatest && reject_greatest) my_err = 2;
        greatest_out[i] = greatest;
        if (inf_out) inf_out[i] = inf;

        uint32_t* dout = digits_out + i * (int64_t)ncoords * nw;
        for (int c = 0; c < ncoords && !my_err; c++) {
            const uint8_t* cb = e + c * coord_bytes;
            uint8_t b0 = (c == 0) ? (uint8_t)(cb[0] & 0x3F) : cb[0];
            if (inf && !reject_inf) {
                memset(dout + c * nw, 0, nw * sizeof(uint32_t));
                continue;
            }
            if (check_lt_q) {
                // big-endian lexicographic compare vs the modulus
                int cmp = (int)b0 - (int)qbytes[0];
                for (int k = 1; k < coord_bytes && cmp == 0; k++)
                    cmp = (int)cb[k] - (int)qbytes[k];
                if (cmp >= 0) { my_err = 3; break; }
            }
            // big-endian bytes -> little-endian 16-bit digits
            uint32_t* d = dout + c * nw;
            d[nw - 1] = ((uint32_t)b0 << 8) | cb[1];
            for (int k = 1; k < nw; k++)
                d[nw - 1 - k] = ((uint32_t)cb[2 * k] << 8) | cb[2 * k + 1];
        }
        if (my_err) {
#pragma omp critical
            {
                if (err == 0 || i < bad) { err = my_err; bad = i; }
            }
        }
    }
    if (bad_index) *bad_index = bad;
    return err;
}

// ---------------------------------------------------------------------------
// encode: packed device pull -> raw bytes
// ---------------------------------------------------------------------------
//
// `packed` is the single-pull row layout the device canonicalization kernels
// emit: `stride` uint32 columns per element, coordinates at arbitrary column
// offsets (so the G2 c1||c0 file order is just a column map).  Digits are
// little-endian; output is the concatenation of big-endian coordinates.
// If greatest_col >= 0, OR 0x80 into byte 0 when that column is nonzero
// (compressed formats).  inf_mask (optional) zeroes the element and writes
// the 0x40 flag (radix-file serialization allows infinities).
void p2_encode_digits(const uint32_t* packed, int64_t n, int stride,
                      const int32_t* coord_cols, int ncoords, int nw,
                      int greatest_col, const uint8_t* inf_mask,
                      uint8_t* out) {
    const int coord_bytes = 2 * nw;
    const int esize = ncoords * coord_bytes;

#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; i++) {
        const uint32_t* row = packed + i * (int64_t)stride;
        uint8_t* e = out + i * esize;
        if (inf_mask && inf_mask[i]) {
            memset(e, 0, esize);
            e[0] = 0x40;
            continue;
        }
        for (int c = 0; c < ncoords; c++) {
            const uint32_t* d = row + coord_cols[c];
            uint8_t* cb = e + c * coord_bytes;
            for (int k = 0; k < nw; k++) {
                uint32_t v = d[nw - 1 - k];
                cb[2 * k] = (uint8_t)(v >> 8);
                cb[2 * k + 1] = (uint8_t)v;
            }
        }
        if (greatest_col >= 0 && row[greatest_col]) e[0] |= 0x80;
    }
}

// ---------------------------------------------------------------------------
// standalone swizzles (drop-in replacements for the numpy helpers)
// ---------------------------------------------------------------------------

// uint8 (n, 2*nw) big-endian -> uint32 (n, nw) LE digits
void p2_be_to_digits(const uint8_t* in, int64_t n, int nw, uint32_t* out) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; i++) {
        const uint8_t* b = in + i * 2 * nw;
        uint32_t* d = out + i * (int64_t)nw;
        for (int k = 0; k < nw; k++)
            d[nw - 1 - k] = ((uint32_t)b[2 * k] << 8) | b[2 * k + 1];
    }
}

// uint32 (n, nw) LE digits -> uint8 (n, 2*nw) big-endian
void p2_digits_to_be(const uint32_t* in, int64_t n, int nw, uint8_t* out) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; i++) {
        const uint32_t* d = in + i * (int64_t)nw;
        uint8_t* b = out + i * 2 * nw;
        for (int k = 0; k < nw; k++) {
            uint32_t v = d[nw - 1 - k];
            b[2 * k] = (uint8_t)(v >> 8);
            b[2 * k + 1] = (uint8_t)v;
        }
    }
}

}  // extern "C"
