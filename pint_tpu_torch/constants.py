"""Physical and astronomical constants (SI) used by the port's main path.

The values are those of the JAX package's ``constants`` module (IAU 2015 /
CODATA); only the ones the port reads are kept here.
"""

import math

SECS_PER_DAY = 86400.0
DAYS_PER_JULIAN_YEAR = 365.25
SECS_PER_JULIAN_YEAR = SECS_PER_DAY * DAYS_PER_JULIAN_YEAR

C = 299792458.0  # m/s, exact
AU = 149597870700.0  # m, IAU 2012 exact
AU_LIGHT_SEC = AU / C  # ~499.004783836 s

ARCSEC_TO_RAD = math.pi / (180.0 * 3600.0)
MAS_TO_RAD = ARCSEC_TO_RAD * 1e-3
DEG_TO_RAD = math.pi / 180.0
HOUR_TO_RAD = math.pi / 12.0

GM_SUN = 1.32712440041279419e20
GM_MERCURY = 2.2031868551e13
GM_VENUS = 3.24858592000e14
GM_EARTH = 3.98600435507e14
GM_MOON = 4.902800118e12
GM_MARS = 4.2828375816e13  # Mars system
GM_JUPITER = 1.26712764100000e17  # Jupiter system
GM_SATURN = 3.79405852000000e16  # Saturn system
GM_URANUS = 5.794556400000e15  # Uranus system
GM_NEPTUNE = 6.836527100580e15  # Neptune system

#: Shapiro factor 2/c^3: times GM gives seconds
SHAPIRO_T2 = 2.0 / C**3

#: GM_sun / c^3 in seconds (a binary's M2 in solar masses -> seconds)
TSUN = GM_SUN / C**3

#: IAU 2006 mean obliquity of the ecliptic at J2000 (ecliptic astrometry)
OBL_J2000 = 84381.406 * ARCSEC_TO_RAD

#: delay = DM * DM_CONST / freq_MHz^2 seconds (Tempo convention)
DM_CONST = 1.0 / 2.41e-4

#: one cycle per Julian year, Hz (power-law red-noise reference frequency)
F_YR = 1.0 / SECS_PER_JULIAN_YEAR

#: IAU 2006 Resolution B3: dTDB/dTCB = 1 - L_B, and TDB - TCB at the
#: 1977-01-01 origin (seconds)
L_B = 1.550519768e-8
TDB0 = -6.55e-5

#: TCG vs TT rate (IAU 2000 Resolution B1.9, exact) and TT - TAI (s)
L_G = 6.969290134e-10
TT_MINUS_TAI = 32.184

#: the J2000.0 epoch as MJD (TT)
MJD_J2000 = 51544.5

PC = 3.0856775814913673e16  # m (parsec, derived from AU / arcsec)
