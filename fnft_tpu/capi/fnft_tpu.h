/* fnft_tpu.h — C API of the fnft-tpu framework.
 *
 * Drop-in style counterparts of the reference FNFT C library's public
 * drivers (include/fnft_nsev.h:371-376, fnft_kdvv.h:104-109,
 * fnft_nsep.h:263-267, fnft_nsev_inverse.h:275-286), backed by the
 * JAX implementation through an embedded CPython interpreter.
 *
 * Differences from the reference API, by design:
 *   - every function takes a JSON options string instead of an opts
 *     struct pointer (pass NULL for the reference defaults); keys map
 *     1:1 to the Python opts dataclasses, e.g.
 *       "{\"discretization\": \"2split4b\", \"contspec_type\": \"both\"}"
 *   - *K_ptr / *M_ptr are IN/OUT: in = capacity of the caller's arrays,
 *     out = number of points found (excess points are dropped).
 *   - the first call initializes the embedded interpreter and compiles
 *     the kernels (seconds); subsequent calls with the same geometry
 *     reuse the compiled programs.
 *
 * Thread safety: calls are serialized through the CPython GIL; the
 * last-error buffer is process-global.
 *
 * Environment:
 *   FNFT_TPU_PYTHON    interpreter to embed (default: baked at build)
 *   FNFT_TPU_PKG_ROOT  directory containing the fnft_tpu package
 *   FNFT_TPU_PLATFORM  jax platform override: "cpu" or "gpu"
 *
 * Return codes: 0 success, 1 invalid argument, 2 internal error,
 * 3 embedding/initialization failure. fnft_tpu_last_error() returns a
 * message for the most recent failure.
 */
#ifndef FNFT_TPU_H
#define FNFT_TPU_H

#include <complex.h>
#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef double complex fnft_tpu_complex;

/* Version of the reference API this library provides parity with;
 * suffix identifies the fnft-tpu build. Mirrors fnft_version. */
int fnft_tpu_version(uint32_t *major, uint32_t *minor, uint32_t *patch,
                     char suffix[32]);

/* Forward NFT, vanishing NSE (mirrors fnft_nsev).
 *   d, q        D time samples
 *   t           T[0], T[1]
 *   m, contspec M xi samples out; contspec must hold M, 2M or 3M entries
 *               for contspec_type reflection / ab / both
 *   xi          XI[0], XI[1]
 *   k_ptr       in: capacity of bound_states/normconsts; out: #found
 *   normconsts_or_residues must hold *k_ptr or 2*k_ptr entries for
 *               discspec_type norming_constants|residues / both
 *   kappa       +1 focusing, -1 defocusing */
int fnft_tpu_nsev(size_t d, const fnft_tpu_complex *q, const double t[2],
                  size_t m, fnft_tpu_complex *contspec, const double xi[2],
                  size_t *k_ptr, fnft_tpu_complex *bound_states,
                  fnft_tpu_complex *normconsts_or_residues, int32_t kappa,
                  const char *opts_json);

/* Forward NFT, vanishing KdV (mirrors fnft_kdvv; bound-state slots are
 * the fnft-tpu extension — pass k_ptr = NULL for reference behavior). */
int fnft_tpu_kdvv(size_t d, const fnft_tpu_complex *u, const double t[2],
                  size_t m, fnft_tpu_complex *contspec, const double xi[2],
                  size_t *k_ptr, fnft_tpu_complex *bound_states,
                  const char *opts_json);

/* Forward NFT, (quasi-)periodic NSE (mirrors fnft_nsep).
 * sheet_indices is not implemented (same as the reference) — pass NULL. */
int fnft_tpu_nsep(size_t d, const fnft_tpu_complex *q, const double t[2],
                  double phase_shift, size_t *k_ptr,
                  fnft_tpu_complex *main_spec, size_t *m_ptr,
                  fnft_tpu_complex *aux_spec, double *sheet_indices,
                  int32_t kappa, const char *opts_json);

/* Inverse NFT, vanishing NSE (mirrors fnft_nsev_inverse).
 * contspec may be NULL (pure multi-soliton synthesis). */
int fnft_tpu_nsev_inverse(size_t m, const fnft_tpu_complex *contspec,
                          const double xi[2], size_t k,
                          const fnft_tpu_complex *bound_states,
                          const fnft_tpu_complex *normconsts_or_residues,
                          size_t d, fnft_tpu_complex *q, const double t[2],
                          int32_t kappa, const char *opts_json);

/* Canonical spectral grid for the inverse NFT (mirrors
 * fnft_nsev_inverse_XI): writes XI[0], XI[1] for an M-point transform of
 * D samples on T. opts_json accepts {"discretization": ...} (default
 * 2split2a, like the reference default opts). */
int fnft_tpu_nsev_inverse_xi(size_t d, const double t[2], size_t m,
                             double xi[2], const char *opts_json);

/* Message for the most recent non-zero return code. */
const char *fnft_tpu_last_error(void);

#ifdef __cplusplus
}
#endif

#endif /* FNFT_TPU_H */
