"""The motion-only solve of ``plain.py`` with central differences that never
straddle the projection guard.

``plain.MotionOnly.jac`` differences each observation's residuals at
``plain.FD_STEP`` on either side of the pose. The projection divides by the
camera depth z only where ``|z| >= plain.Z_GUARD`` (else by 1), so for a
landmark within about ``FD_STEP`` times its lever arm of that plane one side
of the difference projects and the other does not, and the column is
garbage. A rotation step turns the landmark about the drive's origin, so
the lever arm is its distance from there: a landmark 0.01004 m in front of
the camera's plane and 73.9 m from the origin read a column of 6.6e10 px
per unit step where a step of 1e-7 reads 8.0e8, and the motion-only solve
ended 1.28 cm from where it ends with that column (where the program's
solve ends too, in float32 and in float64, 1.4e-6 to 2.0e-6 m away).

:class:`GuardedMotionOnly` takes each such observation's column again at
steps ten times shorter until both sides fall on the side of the guard the
pose itself is on. Every other column is ``plain``'s own. :func:`guarded`
has ``plain.frame`` build its motion-only solve from this class for the
duration of a ``with`` block.
"""

from __future__ import annotations

import numpy as np

from . import plain

# steps tried per column: FD_STEP, FD_STEP / 10, ..., FD_STEP / 10**3
SHRINKS = 4


class GuardedMotionOnly(plain.MotionOnly):

    def jac(self, pose):
        g = plain.Z_GUARD
        side = np.abs(self.residuals(pose)[1]) >= g
        J = np.empty((self.lm_pos.shape[0], 3, 6))
        for i in range(6):
            todo = np.ones(side.shape, bool)
            h = plain.FD_STEP
            for k in range(SHRINKS):
                e = np.zeros(6)
                e[i] = h
                rp, zp = self.residuals(plain.boxplus(pose, e))
                rm, zm = self.residuals(plain.boxplus(pose, -e))
                ok = ((np.abs(zp) >= g) == side) & ((np.abs(zm) >= g) == side)
                take = todo & (ok | (k == SHRINKS - 1))
                J[take, :, i] = ((rp - rm) / (2 * h))[take]
                todo &= ~take
                if not todo.any():
                    break
                h /= 10
        return J


class guarded:
    """``plain.frame``'s motion-only solve as :class:`GuardedMotionOnly`
    inside the ``with`` block."""

    def __enter__(self):
        self.inner, plain.MotionOnly = plain.MotionOnly, GuardedMotionOnly
        return self

    def __exit__(self, *exc):
        plain.MotionOnly = self.inner
