// The Jacobi rotation of kernels K1, K2 and K3 (csrc/eig3.cu,
// csrc/kabsch3.cu, csrc/eig9.cu). K2 rotates columns p, q of H by the
// rotation that diagonalises their Gram block (app, aqq the squared
// norms, apq the dot product): a one-sided Jacobi step.
#pragma once

#include <cfloat>
#include <climits>

// The rotation J = [[c, s], [-s, c]] in the (p, q) plane that makes
// J^T [[app, apq], [apq, aqq]] J diagonal, by the smaller of its two
// angles (Golub and Van Loan, sym.schur2), and t apq with t = s / c: the
// new diagonal is app - t apq and aqq + t apq, and apq becomes 0.
// With h = (aqq - app) / 2, r = sqrt(h^2 + apq^2) (half the 2x2 block's
// eigenvalue gap), u = |h| + r and w = 1 / sqrt(u^2 + apq^2):
//   c = u w,   s = sgn(h) apq w,   t apq = sgn(h) apq^2 / u = s apq w 2 r
// (u^2 + apq^2 = 2 r u), sgn(h) the sign bit of h. Two reciprocal square
// roots, r = x rsqrt(x), and no division (sym.schur2 as written divides
// twice and takes a square root and a reciprocal one): every sum adds
// terms of one sign, so nothing cancels, and c^2 + s^2 = 1 to a few ulps
// whatever the last bits of r, which only set the angle. Needs h^2 +
// apq^2 and u^2 + apq^2 finite: K1's float32 entries always are, and so
// are K2's Gram entries (each under 3 FLT_MAX^2 < 1e78), K3 scales its
// matrix first. Returns false, and sets nothing, where apq^2 is under
// DBL_MIN (|apq| < 1.5e-154, or NaN): the caller sets apq to 0 (K2: the
// pair counts as orthogonal) and rotates nothing.
__device__ __forceinline__ bool jacobi_rotation(double app, double aqq,
                                                double apq, double& c,
                                                double& s, double& ta) {
  const double aa = apq * apq;
  if (!(aa >= DBL_MIN)) return false;
  const double h = 0.5 * (aqq - app);
  const double x = fma(h, h, aa);
  const double r = x * rsqrt(x);
  const double u = fabs(h) + r;
  const double w = rsqrt(fma(u, u, aa));
  const double p = apq * w;
  c = u * w;
  // sgn(h) p, by the sign bit: no float64 negation or compare
  s = __hiloint2double(__double2hiint(p) ^ (__double2hiint(h) & INT_MIN),
                       __double2loint(p));
  ta = s * p * (r + r);
  return true;
}
