"""Self-contained solar-system ephemeris (host float64 numpy).

The port's own copy of ``scintools_tpu/utils/ephemeris.py:61-234``:
Earth's barycentric position and velocity from the JPL approximate
Keplerian elements (valid 1800–2050 AD) of the Earth–Moon barycentre,
plus the Sun's barycentric wobble from the four giant planets. Position
is good to ~1e-4 AU (Roemer delay to ~0.05 s), velocity to ~15 m/s (the
Earth–Moon orbit is left out), ample where Earth's motion enters at
30 km/s. The pulsar's unit vector is equatorial (the reference mixes an
ecliptic frame into ``get_ssb_delay``; the JAX package corrects it, and
so does this copy). ``earth_position_bary``, ``earth_velocity_bary``,
``get_ssb_delay``, ``get_earth_velocity``, ``icrs_to_galactic``,
``make_lsr`` and ``differential_velocity``.
"""

from __future__ import annotations

import numpy as np

from ..io.parfile import _hms_to_rad, _dms_to_rad
from .orbit import kepler_solve

AU_M = 149597870700.0          # m
C_M_S = 299792458.0            # m/s
DAY_S = 86400.0
OBLIQUITY_DEG = 23.43928

# JPL approximate elements at J2000 + rates per Julian century:
# (a [AU], e, I [deg], L [deg], varpi [deg], Omega [deg]) and rates.
_ELEMENTS = {
    "embary": ((1.00000261, 0.01671123, -0.00001531, 100.46457166,
                102.93768193, 0.0),
               (0.00000562, -0.00004392, -0.01294668, 35999.37244981,
                0.32327364, 0.0)),
    "jupiter": ((5.20288700, 0.04838624, 1.30439695, 34.39644051,
                 14.72847983, 100.47390909),
                (-0.00011607, -0.00013253, -0.00183714, 3034.74612775,
                 0.21252668, 0.20469106)),
    "saturn": ((9.53667594, 0.05386179, 2.48599187, 49.95424423,
                92.59887831, 113.66242448),
               (-0.00125060, -0.00050991, 0.00193609, 1222.49362201,
                -0.41897216, -0.28867794)),
    "uranus": ((19.18916464, 0.04725744, 0.77263783, 313.23810451,
                170.95427630, 74.01692503),
               (-0.00196176, -0.00004397, -0.00242939, 428.48202785,
                0.40805281, 0.04240589)),
    "neptune": ((30.06992276, 0.00859048, 1.77004347, -55.12002969,
                 44.96476227, 131.78422574),
                (0.00026291, 0.00005105, 0.00035372, 218.45945325,
                 -0.32241464, -0.00508664)),
}

# reciprocal masses M_sun/M_planet
_RMASS = {"jupiter": 1047.3486, "saturn": 3497.898,
          "uranus": 22902.98, "neptune": 19412.24}


def _helio_ecliptic(body, T):
    """Heliocentric ecliptic xyz [AU] of ``body`` at Julian centuries
    ``T`` past J2000 (JPL approximate-elements algorithm)."""
    el0, elr = _ELEMENTS[body]
    a = el0[0] + elr[0] * T
    e = el0[1] + elr[1] * T
    I = np.deg2rad(el0[2] + elr[2] * T)
    L = np.deg2rad(el0[3] + elr[3] * T)
    varpi = np.deg2rad(el0[4] + elr[4] * T)
    Omega = np.deg2rad(el0[5] + elr[5] * T)
    omega = varpi - Omega
    M = np.mod(L - varpi + np.pi, 2 * np.pi) - np.pi
    E = kepler_solve(M, e)
    xp = a * (np.cos(E) - e)
    yp = a * np.sqrt(1 - e ** 2) * np.sin(E)
    co, so = np.cos(omega), np.sin(omega)
    cO, sO = np.cos(Omega), np.sin(Omega)
    cI, sI = np.cos(I), np.sin(I)
    x = (co * cO - so * sO * cI) * xp + (-so * cO - co * sO * cI) * yp
    y = (co * sO + so * cO * cI) * xp + (-so * sO + co * cO * cI) * yp
    z = (so * sI) * xp + (co * sI) * yp
    return np.stack([x, y, z], axis=-1)


def _ecl_to_equ(xyz):
    eps = np.deg2rad(OBLIQUITY_DEG)
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    return np.stack([x,
                     y * np.cos(eps) - z * np.sin(eps),
                     y * np.sin(eps) + z * np.cos(eps)], axis=-1)


def earth_position_bary(mjd):
    """Barycentric equatorial position of Earth(-Moon barycenter)
    [AU] at MJD (scalar or array)."""
    T = (np.asarray(mjd, dtype=float) - 51544.5) / 36525.0
    r = _helio_ecliptic("embary", T)
    # Sun's barycentric offset from the giant planets
    total = 1.0 + sum(1.0 / m for m in _RMASS.values())
    r_sun = 0.0
    for body, rmass in _RMASS.items():
        r_sun = r_sun - _helio_ecliptic(body, T) / rmass
    r_sun = r_sun / total
    return _ecl_to_equ(r + r_sun)


def earth_velocity_bary(mjd, dt_days=0.25):
    """Barycentric equatorial velocity of Earth [AU/day] by central
    differences of the analytic position."""
    mjd = np.asarray(mjd, dtype=float)
    return ((earth_position_bary(mjd + dt_days)
             - earth_position_bary(mjd - dt_days)) / (2 * dt_days))


def _psr_unit_equatorial(raj, decj):
    ra = raj if isinstance(raj, (int, float)) else _hms_to_rad(raj)
    dec = decj if isinstance(decj, (int, float)) else _dms_to_rad(decj)
    return np.array([np.cos(dec) * np.cos(ra),
                     np.cos(dec) * np.sin(ra),
                     np.sin(dec)]), ra, dec


def get_ssb_delay(mjds, raj, decj, message=False):
    """Roemer delay [s] to the solar-system barycentre
    (scint_utils.py:286-311 role). Positive values should be ADDED to
    site arrival times."""
    psr, _, _ = _psr_unit_equatorial(raj, decj)
    pos = earth_position_bary(np.atleast_1d(mjds))
    t = pos @ psr * AU_M / C_M_S
    if message:
        print("Returned SSB Roemer delays (in seconds) should be "
              "ADDED to site arrival times")
    return np.asarray(t)


def get_earth_velocity(mjds, raj, decj, radial=False):
    """Earth velocity transverse to the line of sight in RA/DEC [km/s]
    (scint_utils.py:349-395)."""
    _, ra, dec = _psr_unit_equatorial(raj, decj)
    v = earth_velocity_bary(np.atleast_1d(mjds))  # AU/day equatorial
    vx, vy, vz = v[..., 0], v[..., 1], v[..., 2]
    vearth_ra = -vx * np.sin(ra) + vy * np.cos(ra)
    vearth_dec = (-vx * np.sin(dec) * np.cos(ra)
                  - vy * np.sin(dec) * np.sin(ra) + vz * np.cos(dec))
    scale = AU_M / 1e3 / DAY_S  # AU/day → km/s
    if radial:
        vearth_r = (vx * np.cos(dec) * np.cos(ra)
                    + vy * np.cos(dec) * np.sin(ra) + vz * np.sin(dec))
        return (vearth_ra * scale).squeeze(), \
            (vearth_dec * scale).squeeze(), (vearth_r * scale).squeeze()
    return (vearth_ra * scale).squeeze(), (vearth_dec * scale).squeeze()


# --------------------------------------------------------------------------
# Galactic-frame helpers (for make_lsr / differential_velocity)
# --------------------------------------------------------------------------

# ICRS → Galactic rotation (IAU 1958 pole/centre, standard matrix)
_ICRS_TO_GAL = np.array([
    [-0.0548755604, -0.8734370902, -0.4838350155],
    [0.4941094279, -0.4448296300, 0.7469822445],
    [-0.8676661490, -0.1980763734, 0.4559837762],
])

# Solar peculiar motion w.r.t. LSR [km/s] in galactic (U, V, W)
_V_SUN_LSR = np.array([11.1, 12.24, 7.25])

KM_PER_KPC = 3.085677581e16
MASYR_TO_KMS_KPC = 4.740470446  # v[km/s] = 4.7405 · mu[mas/yr] · d[kpc]


def icrs_to_galactic(ra, dec):
    """(l, b) radians from equatorial radians."""
    u = np.array([np.cos(dec) * np.cos(ra), np.cos(dec) * np.sin(ra),
                  np.sin(dec)])
    g = _ICRS_TO_GAL @ u
    return np.arctan2(g[1], g[0]) % (2 * np.pi), np.arcsin(g[2])


def make_lsr(d, raj, decj, pmra, pmdec, vr=0):
    """Proper motion corrected to the LSR frame
    (scint_utils.py:314-346 role): μ_LSR = μ + (v☉·ê)/(4.74·d).

    ``vr`` is accepted for signature parity; a pure frame-velocity
    offset changes the returned proper motion only through its
    tangential projection, so the source radial velocity drops out
    (it would only matter for the returned RV, which the reference
    also discards — it returns ``proper_motion`` alone)."""
    _, ra, dec = _psr_unit_equatorial(raj, decj)
    e_ra = np.array([-np.sin(ra), np.cos(ra), 0.0])
    e_dec = np.array([-np.sin(dec) * np.cos(ra),
                      -np.sin(dec) * np.sin(ra), np.cos(dec)])
    v_sun_eq = _ICRS_TO_GAL.T @ _V_SUN_LSR  # galactic → equatorial
    dmu_ra = (v_sun_eq @ e_ra) / (MASYR_TO_KMS_KPC * d)
    dmu_dec = (v_sun_eq @ e_dec) / (MASYR_TO_KMS_KPC * d)
    return np.array([pmra + dmu_ra, pmdec + dmu_dec])


def differential_velocity(params, sun_velocity=220, screen_velocity=220,
                          radius=8):
    """Differential galactic-rotation velocity between screen and Sun
    (scint_utils.py:600-652), assuming flat rotation and circular
    zero-inclination orbits."""
    raj = params["RAJ"]
    decj = params["DECJ"]
    ra = raj.value if hasattr(raj, "value") else raj
    dec = decj.value if hasattr(decj, "value") else decj
    if isinstance(ra, str):
        ra = _hms_to_rad(ra)
        dec = _dms_to_rad(dec)
    s = params["s"].value if hasattr(params["s"], "value") else params["s"]
    d = params["d"].value if hasattr(params["d"], "value") else params["d"]

    gal_l, gal_b = icrs_to_galactic(ra, dec)
    long = 2 * np.pi - gal_l
    dscr = (1 - s) * d
    rscr = np.sqrt(dscr ** 2 + radius ** 2
                   - 2 * dscr * radius * np.cos(long))
    costheta = radius / rscr - dscr * np.cos(long) / rscr
    phi = long + np.arccos(np.clip(costheta, -1, 1))
    vtrans_scr = screen_velocity * np.cos(phi)
    vtrans_sun = sun_velocity * np.cos(long)
    diff_vel = vtrans_scr - vtrans_sun

    # direction of increasing galactic longitude on the sky, in RA/DEC
    gal2 = np.array([gal_l + np.deg2rad(1), gal_b])
    u2 = np.array([np.cos(gal2[1]) * np.cos(gal2[0]),
                   np.cos(gal2[1]) * np.sin(gal2[0]),
                   np.sin(gal2[1])])
    eq2 = _ICRS_TO_GAL.T @ u2
    ra2 = np.arctan2(eq2[1], eq2[0])
    dec2 = np.arcsin(eq2[2])
    angle = np.pi / 2 - np.arctan((dec2 - dec) / (ra2 - ra))
    return diff_vel * np.sin(angle), diff_vel * np.cos(angle)
