"""Fit Helmholtz photoionization modes to an absorption function.

Twin of the JAX package's ``tools/absorption_function.py``, on this
package's ``physics/photoi_mc.absorption_func_air`` (host NumPy):
``python -m afivo_streamer_tpu_torch.tools.absorption_function [-p_O2 P]
[-fit_range R0 R1] [-n_modes N] [-n_points N] [-fit_type T] [-plot]``.

Functional equivalent of the reference's ``tools/absorption_function.py``
core workflow: take the Zheleznyak absorption function for air (or a
custom tabulated function), and fit ``n_modes`` Helmholtz modes so that

    f(r)/(p_O2) ~ sum_j  A_j * (p_O2*r) * lambda_j^2 * exp(-lambda_j*p_O2*r)

matches it over a distance range. The resulting coefficients can be used
with ``photoi_helmh%author = custom`` (``photoi_helmh%lambdas``,
``photoi_helmh%coeffs``).
"""

import argparse

import numpy as np

from ..physics.photoi_mc import absorption_func_air


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Fit Helmholtz modes to the air absorption function")
    p.add_argument("-p_O2", type=float, default=0.2,
                   help="Partial pressure of O2 (bar)")
    p.add_argument("-fit_range", nargs=2, type=float,
                   default=[1e-4, 3e-3],
                   help="Distance range (m) for the fit")
    p.add_argument("-n_modes", type=int, default=3,
                   help="Number of Helmholtz modes")
    p.add_argument("-n_points", type=int, default=400)
    p.add_argument("-fit_type", default="log",
                   choices=["least_squares", "relative", "log"])
    p.add_argument("-plot", action="store_true")
    args = p.parse_args(argv)

    from scipy.optimize import curve_fit

    r = np.geomspace(args.fit_range[0], args.fit_range[1], args.n_points)
    f = absorption_func_air(r, args.p_O2)

    n = args.n_modes

    def model(r, *cl):
        c = np.asarray(cl[:n])
        lam = np.asarray(cl[n:])
        pr = args.p_O2 * r[:, None]
        return (args.p_O2 ** 2 * pr * (c * lam ** 2)
                * np.exp(-lam * pr)).sum(axis=1) / args.p_O2

    # fit in log-parameters (positivity) with guesses spanning the
    # observed decay scales of the Zheleznyak function
    lam0 = np.geomspace(0.5 / (args.p_O2 * r[-1]),
                        2.0 / (args.p_O2 * r[0]), n)
    c0 = np.full(n, max(np.max(f), 1e-300) / n)

    def model_logp(r, *logcl):
        return model(r, *np.exp(np.asarray(logcl)))

    p0 = np.log(np.concatenate([c0, lam0]))

    if args.fit_type == "log":
        def resid_target(r):
            return np.log(np.maximum(f, 1e-300))

        def fitfun(r, *cl):
            return np.log(np.maximum(model_logp(r, *cl), 1e-300))
    elif args.fit_type == "relative":
        def resid_target(r):
            return np.ones_like(f)

        def fitfun(r, *cl):
            return model_logp(r, *cl) / np.maximum(f, 1e-300)
    else:
        def resid_target(r):
            return f

        fitfun = model_logp

    popt, _ = curve_fit(fitfun, r, resid_target(r), p0=p0, maxfev=100000)
    popt = np.exp(popt)
    coeffs, lambdas = popt[:n], popt[n:]
    order = np.argsort(lambdas)
    coeffs, lambdas = coeffs[order], lambdas[order]

    print("# Helmholtz fit of the absorption function "
          f"(p_O2 = {args.p_O2} bar, range {args.fit_range})")
    print("photoi_helmh%author = 'custom'")
    print("photoi_helmh%lambdas =",
          " ".join(f"{x:.6e}" for x in lambdas))
    print("photoi_helmh%coeffs =",
          " ".join(f"{x:.6e}" for x in coeffs))
    rel = (np.abs(model(r, *popt) - f)
           / np.maximum(np.abs(f), 1e-300))
    print(f"# max relative fit error: {rel.max():.3e}")

    if args.plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        plt.loglog(r, f, label="absorption function")
        plt.loglog(r, model(r, *popt), "--", label="Helmholtz fit")
        plt.xlabel("r (m)")
        plt.legend()
        plt.savefig("absorption_fit.png", dpi=150)
        print("# wrote absorption_fit.png")


if __name__ == "__main__":
    main()
