// Native text-grid formatter of the PyTorch/CUDA port: the reference's
// printf("%6.1f") .dat layouts over whole grids, behind a plain C
// interface that ctypes loads (heat2d_tpu_torch/native/lib.py).
//
// The reference writes its .dat files with C stdio (prtdat,
// mpi_heat2Dn.c:253-268; the binary->text loop, grad1612_mpi_heat.c:
// 191-203). Python's "%6.1f" gives the same bytes for the same double;
// this path exists because formatting value by value in Python is what
// dominates writing a 2560x2048 grid.
//
// A float's "%6.1f" is computed exactly in integers (put_value): the
// float is m * 2^e with a 24-bit m, so its value in tenths is 10 m 2^e,
// rounded half to even as printf and Python round an exact tie. Values
// whose integer part passes 2^63 and non-finite values go to snprintf
// (a NaN is written unsigned, as Python writes it).
//
// Built at first use with the host's g++ into build/native/ (lib.py):
//     g++ -O2 -Wall -fPIC -shared heat2d_io.cpp -o libheat2d_io_<hash>.so

#include <cstdint>
#include <cstdio>
#include <cstring>

namespace {

// Writes "%6.1f" of f at out (room for 64 bytes); returns its length.
int put_value(char* out, float f) {
    uint32_t bits;
    std::memcpy(&bits, &f, sizeof bits);
    const bool neg = bits >> 31;
    const uint32_t ex = (bits >> 23) & 0xff;
    const uint64_t m = (ex ? (bits & 0x7fffff) | 0x800000 : bits & 0x7fffff);
    const int e = (ex ? static_cast<int>(ex) - 150 : -149);
    if (ex == 0xff) {
        if (bits & 0x7fffff) return snprintf(out, 64, "%6s", "nan");
        return snprintf(out, 64, "%6.1f", static_cast<double>(f));
    }
    uint64_t tenths;
    if (e >= 0) {
        if (e > 35) return snprintf(out, 64, "%6.1f", static_cast<double>(f));
        tenths = (m << e) * 10;
    } else {
        const int s = -e;
        const uint64_t t = m * 10;            // < 2^28
        if (s > 29) {
            tenths = 0;                        // t < 2^(s-1): rounds to 0
        } else {
            tenths = t >> s;
            const uint64_t r = t & ((uint64_t(1) << s) - 1);
            const uint64_t half = uint64_t(1) << (s - 1);
            if (r > half || (r == half && (tenths & 1))) ++tenths;
        }
    }
    char digits[32];
    int n = 0;
    digits[n++] = static_cast<char>('0' + tenths % 10);
    digits[n++] = '.';
    uint64_t ip = tenths / 10;
    do {
        digits[n++] = static_cast<char>('0' + ip % 10);
        ip /= 10;
    } while (ip);
    if (neg) digits[n++] = '-';
    int w = 0;
    for (int pad = 6 - n; pad > 0; --pad) out[w++] = ' ';
    while (n) out[w++] = digits[--n];
    return w;
}

}  // namespace

extern "C" {

// Row-major layout (the grad1612 writers): every value "%6.1f " with a
// trailing space, a newline per row. Returns the bytes written, or -1 if
// ``cap`` is too small.
long heat2d_format_rowmajor(const float* u, long nx, long ny, char* out,
                            long cap) {
    long w = 0;
    for (long i = 0; i < nx; ++i) {
        for (long j = 0; j < ny; ++j) {
            if (cap - w < 64) return -1;
            w += put_value(out + w, u[i * ny + j]);
            out[w++] = ' ';
        }
        if (cap - w < 2) return -1;
        out[w++] = '\n';
    }
    return w;
}

// Baseline layout (mpi_heat2Dn.c prtdat): lines run over the y index
// descending, each over x ascending; one space between values, none at
// the end of a line.
long heat2d_format_baseline(const float* u, long nx, long ny, char* out,
                            long cap) {
    long w = 0;
    for (long iy = ny - 1; iy >= 0; --iy) {
        for (long ix = 0; ix < nx; ++ix) {
            if (cap - w < 64) return -1;
            w += put_value(out + w, u[ix * ny + iy]);
            out[w++] = (ix != nx - 1) ? ' ' : '\n';
        }
    }
    return w;
}

}  // extern "C"
