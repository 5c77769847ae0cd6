"""Reference accuracy from float32 arithmetic: the double-float (df64) mode.

For devices without float64 units the complex64 pipeline reaches ~1e-5
relative accuracy. The df64 layer recomputes the heavy stages in
float32-PAIR arithmetic (Dekker/Knuth error-free transformations) and
matches the complex128 CPU results to ~1e-13 from float32 ops alone. It
runs on the CPU here; on a GPU use the complex128 drivers (the tier
refuses GPU backends).

Surfaces demonstrated: continuous spectrum, bound states, and the
end-to-end inverse (rho -> q).
"""

import numpy as np

import fnft_tpu as ft


def main():
    ft.use_x64()  # for the complex128 cross-checks on CPU
    import jax.numpy as jnp

    from fnft_tpu.ops.df64_pipeline import (nsev_boundstates_df64,
                                            nsev_contspec_df64)

    d = 1024
    t_span, xi_span = (-25.0, 25.0), (-2.0, 2.0)
    t = np.linspace(*t_span, d)
    q = 1j * 3.2 / np.cosh(t)  # Satsuma-Yajima, 3 solitons

    rho_df = nsev_contspec_df64(q, d=d, m=d, t_span=t_span, xi_span=xi_span)
    ref = ft.nsev(jnp.asarray(q), t_span, m=d, xi_span=xi_span, kappa=+1,
                  want_bound_states=False).reflection_coefficient
    rel = np.sum(np.abs(rho_df - np.asarray(ref))) / np.sum(np.abs(ref))
    print(f"contspec: df64 vs complex128 rel. err = {rel:.2e}")

    rho_32 = ft.nsev(jnp.asarray(q.astype(np.complex64)), t_span, m=d,
                     xi_span=xi_span, kappa=+1,
                     want_bound_states=False).reflection_coefficient
    rel32 = np.sum(np.abs(np.asarray(rho_32) - np.asarray(ref))) \
        / np.sum(np.abs(ref))
    print(f"          complex64 vs complex128 rel. err = {rel32:.2e}")

    lam = nsev_boundstates_df64(q, d=d, t_span=t_span)
    print("bound states (df64):", np.sort(lam.imag))

    # inverse: rho -> q entirely in df64 (defocusing, contspec-only)
    from fnft_tpu import df64
    from fnft_tpu.models.nsev_inverse import nsev_inverse_xi_grid

    d2, m2 = 256, 512
    xi2 = nsev_inverse_xi_grid(d2, t_span, m2)
    t2 = np.linspace(*t_span, d2)
    qd = 0.8 / np.cosh(t2) + 0j
    rho2 = ft.nsev(jnp.asarray(qd), t_span, m=m2, xi_span=xi2, kappa=-1,
                   want_bound_states=False).reflection_coefficient
    q_rec = df64.nsev_inverse(np.asarray(rho2), xi2, d2, t_span, kappa=-1)
    print(f"df64 inverse round-trip max |q_rec - q| = "
          f"{np.max(np.abs(q_rec - qd)):.2e} (discretization error)")


if __name__ == "__main__":
    main()
