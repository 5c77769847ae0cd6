// Native host-side runtime components for fnft-tpu.
//
// The device compute path is JAX/XLA; these are the host-side pieces that sit
// outside the device program and benefit from native code:
//
//   * newton_polygon_init — Bini-style initial root guesses from the upper
//     convex hull of (k, log|c_k|). Sequential hull construction is the one
//     host-side step on the rootfinding hot path (deg can reach ~1e5 for
//     fnft_nsep's subsampled monodromy polynomials, reference degree 105
//     schemes), so it is implemented in C++ rather than Python.
//   * read_signal_batch — zero-copy-ish binary batch loader for streaming
//     NFDM symbol workloads (the "data loader" role; the C reference has
//     no equivalent because it processes one in-memory signal per call).
//
// Plain CPython C API (no pybind11 dependency); fnft_tpu.native falls back
// to numpy implementations when this extension is unavailable.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cmath>
#include <complex>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

// Upper convex hull of (k, logc[k]) over indices with finite logc.
// Returns hull indices (increasing k).
std::vector<Py_ssize_t> upper_hull(const double *logc, Py_ssize_t n) {
    std::vector<Py_ssize_t> hull;
    hull.reserve(64);
    for (Py_ssize_t k = 0; k < n; ++k) {
        if (!std::isfinite(logc[k]))
            continue;
        while (hull.size() >= 2) {
            const Py_ssize_t i = hull[hull.size() - 2];
            const Py_ssize_t j = hull[hull.size() - 1];
            // drop j if it lies on or below the segment (i, k)
            if ((logc[j] - logc[i]) * (double)(k - i) <=
                (logc[k] - logc[i]) * (double)(j - i))
                hull.pop_back();
            else
                break;
        }
        hull.push_back(k);
    }
    return hull;
}

PyObject *newton_polygon_init(PyObject *, PyObject *args) {
    Py_buffer buf;
    if (!PyArg_ParseTuple(args, "y*", &buf))
        return nullptr;
    if (buf.itemsize != sizeof(double)) {
        PyBuffer_Release(&buf);
        PyErr_SetString(PyExc_TypeError, "expected float64 magnitudes");
        return nullptr;
    }
    const Py_ssize_t n1 = buf.len / (Py_ssize_t)sizeof(double);
    const double *absc = static_cast<const double *>(buf.buf);
    const Py_ssize_t deg = n1 - 1;
    if (deg < 1) {
        PyBuffer_Release(&buf);
        PyErr_SetString(PyExc_ValueError, "need at least a degree-1 polynomial");
        return nullptr;
    }

    std::vector<double> logc(n1);
    for (Py_ssize_t k = 0; k < n1; ++k)
        logc[k] = absc[k] > 0.0 ? std::log(absc[k])
                                : -std::numeric_limits<double>::infinity();

    std::vector<std::complex<double>> out;
    out.reserve(deg);
    const double two_pi = 6.283185307179586476925286766559;

    std::vector<Py_ssize_t> hull = upper_hull(logc.data(), n1);
    if (hull.size() < 2) { // degenerate: unit circle fallback
        for (Py_ssize_t j = 0; j < deg; ++j) {
            const double ang = two_pi * ((double)j + 0.5) / (double)deg + 0.3;
            out.emplace_back(std::cos(ang), std::sin(ang));
        }
    } else {
        // leading zero coefficients: "roots at infinity" on a big circle
        if (hull.back() < deg) {
            const Py_ssize_t mm = deg - hull.back();
            for (Py_ssize_t j = 0; j < mm; ++j) {
                const double ang = two_pi * ((double)j + 0.5) / (double)mm;
                out.emplace_back(1e6 * std::cos(ang), 1e6 * std::sin(ang));
            }
        }
        // trailing zero coefficients: roots near zero
        if (hull.front() > 0) {
            const Py_ssize_t mm = hull.front();
            for (Py_ssize_t j = 0; j < mm; ++j) {
                const double ang = two_pi * ((double)j + 0.5) / (double)mm;
                out.emplace_back(1e-6 * std::cos(ang), 1e-6 * std::sin(ang));
            }
        }
        const double sigma = 0.7; // decorrelate circles (Bini sec. 5)
        for (size_t s = 0; s + 1 < hull.size(); ++s) {
            const Py_ssize_t a = hull[s], b = hull[s + 1];
            const Py_ssize_t mm = b - a;
            double r = std::pow(absc[a] / absc[b], 1.0 / (double)mm);
            if (r < 1e-12) r = 1e-12;
            if (r > 1e12) r = 1e12;
            for (Py_ssize_t j = 0; j < mm; ++j) {
                const double ang =
                    two_pi * ((double)j + 0.5) / (double)mm + sigma * (double)b;
                out.emplace_back(r * std::cos(ang), r * std::sin(ang));
            }
        }
    }
    PyBuffer_Release(&buf);
    out.resize(deg);

    PyObject *bytes = PyBytes_FromStringAndSize(
        reinterpret_cast<const char *>(out.data()),
        (Py_ssize_t)(out.size() * sizeof(std::complex<double>)));
    return bytes;
}

PyObject *read_signal_batch(PyObject *, PyObject *args) {
    const char *path = nullptr;
    Py_ssize_t d = 0, offset_signals = 0, count = -1;
    int is_c64 = 1;
    if (!PyArg_ParseTuple(args, "snp|nn", &path, &d, &is_c64, &offset_signals,
                          &count))
        return nullptr;
    const size_t item = is_c64 ? 8 : 16; // complex64 / complex128
    FILE *f = std::fopen(path, "rb");
    if (!f) {
        PyErr_SetFromErrnoWithFilename(PyExc_OSError, path);
        return nullptr;
    }
    std::fseek(f, 0, SEEK_END);
    const long long fsize = std::ftell(f);
    const long long row = (long long)item * d;
    long long total = fsize / row;
    if (count >= 0 && count < total - offset_signals)
        total = offset_signals + count;
    if (offset_signals >= total) {
        std::fclose(f);
        return PyBytes_FromStringAndSize("", 0);
    }
    const long long rows = total - offset_signals;
    std::fseek(f, (long long)offset_signals * row, SEEK_SET);
    PyObject *bytes = PyBytes_FromStringAndSize(nullptr, (Py_ssize_t)(rows * row));
    if (!bytes) {
        std::fclose(f);
        return nullptr;
    }
    char *dst = PyBytes_AS_STRING(bytes);
    size_t got;
    Py_BEGIN_ALLOW_THREADS
    got = std::fread(dst, 1, (size_t)(rows * row), f);
    Py_END_ALLOW_THREADS
    std::fclose(f);
    if (got != (size_t)(rows * row)) {
        Py_DECREF(bytes);
        PyErr_SetString(PyExc_IOError, "short read");
        return nullptr;
    }
    return bytes;
}

PyMethodDef methods[] = {
    {"newton_polygon_init", newton_polygon_init, METH_VARARGS,
     "Bini initial root guesses from |coeffs| (float64 buffer) -> "
     "complex128 bytes of length deg."},
    {"read_signal_batch", read_signal_batch, METH_VARARGS,
     "read_signal_batch(path, D, is_c64, offset=0, count=-1) -> raw bytes"},
    {nullptr, nullptr, 0, nullptr},
};

struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_fnft_native",
    "Native host-side components for fnft-tpu.", -1, methods,
};

}  // namespace

PyMODINIT_FUNC PyInit__fnft_native(void) { return PyModule_Create(&moduledef); }
