"""SIF texts for the SIF decoders of both packages (galahad_tpu/io/sif.py and
galahad_tpu_torch/io/sif.py): the tests (tests/test_torch_sif.py) and
``chip_smoke.py``'s ``constrained`` phase read them from here, never from a
CUTEst tree.  Each is written in the decoder's subset:

  CAMEL6     the six-hump camel function on [-3, 3] x [-1.5, 1.5] (elements
             with powers, 'DEFAULT'-free bounds, a start point per variable)
  HART6      the Hartmann-6 function on [0, 1]^6: parameters (RE), nested DO
             loops, ZV / ZP / ZE lines, a group type with a parameter
             (F = -C EXP(-ALPHA)), 'DEFAULT' bound and start
  ALLINIT    an ALLINIT-like problem in 4 variables: FR / LO / XL+UP / FX
             bounds, CONSTANTS, an L2 group type, an element type with an
             internal variable (IV, R line) and one with temporaries (M, A
             lines) calling SIN
  CONSTR     3 variables, equality / ranged <= / >= constraint groups, and
             a constraint group with no variable (its alpha a constant)
  EXTROSNB   the extended Rosenbrock function in N variables (a parameter),
             its pairs (X(I), Y(I)) declared by one DO loop, groups with
             'SCALE', CONSTANTS and a default L2 group type

``hartmann6`` is HART6's objective written directly, for either package
(``chip_smoke.py``'s DGO case and tests/test_torch_go.py).
"""
import numpy as np

HART6_A = np.array([[10.0, 3.0, 17.0, 3.5, 1.7, 8.0],
                    [0.05, 10.0, 17.0, 0.1, 8.0, 14.0],
                    [3.0, 3.5, 1.7, 10.0, 17.0, 8.0],
                    [17.0, 8.0, 0.05, 10.0, 0.1, 14.0]])
HART6_C = np.array([1.0, 1.2, 3.0, 3.2])
HART6_P = np.array([[0.1312, 0.1696, 0.5569, 0.0124, 0.8283, 0.5886],
                    [0.2329, 0.4135, 0.8307, 0.3736, 0.1004, 0.9991],
                    [0.2348, 0.1451, 0.3522, 0.2883, 0.3047, 0.6650],
                    [0.4047, 0.8828, 0.8732, 0.5743, 0.1091, 0.0381]])


def hartmann6(xp, device=None):
    """-sum_i c_i exp(-sum_j a_ij (x_j - p_ij)^2) for one point x (6,):
    ``xp`` is ``jax.numpy`` or ``torch`` (then the constants are made once on
    ``device``, so an evaluation copies nothing from the host)."""
    if xp.__name__.startswith("jax"):
        a, p, c = (xp.asarray(v) for v in (HART6_A, HART6_P, HART6_C))
    else:
        a, p, c = (xp.as_tensor(v, device=device) for v in (HART6_A, HART6_P, HART6_C))
    return lambda x: -(c * xp.exp(-(a * (x - p) ** 2).sum(-1))).sum()


CAMEL6 = """\
***************************
* SET UP THE INITIAL DATA *
***************************
NAME          CAMEL6
VARIABLES
    X1
    X2
GROUPS
 N  OBJ
BOUNDS
 LO CAMEL6    X1        -3.0
 UP CAMEL6    X1        3.0
 LO CAMEL6    X2        -1.5
 UP CAMEL6    X2        1.5
START POINT
    CAMEL6    X1        1.1
    CAMEL6    X2        1.1
ELEMENT TYPE
 EV SQ        V1
 EV PW4       V1
 EV PW6       V1
 EV 2PR       V1                       V2
ELEMENT USES
 T  E1        SQ
 V  E1        V1                       X1
 T  E2        PW4
 V  E2        V1                       X1
 T  E3        PW6
 V  E3        V1                       X1
 T  E4        2PR
 V  E4        V1                       X1
 V  E4        V2                       X2
 T  E5        SQ
 V  E5        V1                       X2
 T  E6        PW4
 V  E6        V1                       X2
GROUP USES
 E  OBJ       E1        4.0            E2        -2.1
 E  OBJ       E3        0.333333333333333
 E  OBJ       E4
 E  OBJ       E5        -4.0           E6        4.0
ENDATA
ELEMENTS      CAMEL6
INDIVIDUALS
 T  SQ
 F                      V1 * V1
 G  V1                  V1 + V1
 T  PW4
 F                      V1 ** 4
 T  PW6
 F                      V1 ** 6
 T  2PR
 F                      V1 * V2
ENDATA
"""


def _hart6_params() -> str:
    lines = [f" RE C{i + 1}{'':<16}{float(HART6_C[i])!r}" for i in range(4)]
    for i in range(4):
        for j in range(6):
            lines.append(f" RE A{i + 1},{j + 1}{'':<14}{float(HART6_A[i, j])!r}")
            lines.append(f" RE P{i + 1},{j + 1}{'':<14}{float(HART6_P[i, j])!r}")
    return "\n".join(lines)


HART6 = f"""\
NAME          HART6
 IE 1                   1
 IE 4                   4
 IE 6                   6
{_hart6_params()}
VARIABLES
 DO J         1                        6
 X  X(J)
 ND
GROUPS
 DO I         1                        4
 XN OBJ(I)
 ND
BOUNDS
 UP HART6     'DEFAULT' 1.0
START POINT
 V  HART6     'DEFAULT' 0.2
ELEMENT TYPE
 EV SQ        V1
 EP SQ        P
ELEMENT USES
 DO I         1                        4
 DO J         1                        6
 XT E(I,J)    SQ
 ZV E(I,J)    V1                       X(J)
 ZP E(I,J)    P                        P(I,J)
 ND
GROUP TYPE
 GV NEXP      ALPHA
 GP NEXP      C
GROUP USES
 DO I         1                        4
 XT OBJ(I)    NEXP
 DO J         1                        6
 ZE OBJ(I)    E(I,J)                   A(I,J)
 OD J
 ZP OBJ(I)    C                        C(I)
 ND
ENDATA
ELEMENTS      HART6
INDIVIDUALS
 T  SQ
 F                      (V1 - P) ** 2
ENDATA
GROUPS        HART6
INDIVIDUALS
 T  NEXP
 F                      -C * EXP(-ALPHA)
ENDATA
"""

ALLINIT = """\
NAME          ALLINIT
VARIABLES
    X1
    X2
    X3
    X4
GROUPS
 N  FT1
 N  FT2       X3        1.0
 N  FT3
 N  FT4
 N  FT5       X4        1.0
 N  FNT1
 N  FNT2      X4        1.0
 N  FNT3
 N  FNT4      X1        1.0
CONSTANTS
    ALLINIT   FT2       1.0
    ALLINIT   FT5       3.0
    ALLINIT   FNT2      1.0
    ALLINIT   FNT4      4.0
BOUNDS
 FR ALLINIT   X1
 LO ALLINIT   X2        1.0
 XL ALLINIT   X3        -1.0D+10
 UP ALLINIT   X3        1.0
 FX ALLINIT   X4        2.0
START POINT
    ALLINIT   X1        1.0
    ALLINIT   X2        2.0
    ALLINIT   X3        3.0
    ALLINIT   X4        4.0
ELEMENT TYPE
 EV SQR       X
 EV SQR2      Y                        Z
 IV SQR2      X
 EV SINSQR    X
 EV PRODSQR   X                        Y
ELEMENT USES
 T  FT1E1     SQR
 V  FT1E1     X                        X1
 T  FT1E2     SQR
 V  FT1E2     X                        X2
 T  FT3E1     SQR2
 V  FT3E1     Y                        X3
 V  FT3E1     Z                        X4
 T  FT4E1     SINSQR
 V  FT4E1     X                        X3
 T  FT4E2     PRODSQR
 V  FT4E2     X                        X1
 V  FT4E2     Y                        X2
 T  FNT1E1    SQR
 V  FNT1E1    X                        X2
 T  FNT3E1    SQR2
 V  FNT3E1    Y                        X4
 V  FNT3E1    Z                        X1
 T  FNT4E1    SINSQR
 V  FNT4E1    X                        X4
GROUP TYPE
 GV L2        GVAR
GROUP USES
 E  FT1       FT1E1                    FT1E2
 E  FT3       FT3E1
 E  FT4       FT4E1                    FT4E2
 T  FT5       L2
 E  FNT1      FNT1E1
 T  FNT1      L2
 T  FNT2      L2
 E  FNT3      FNT3E1    2.0
 T  FNT3      L2
 E  FNT4      FNT4E1    -1.5
 T  FNT4      L2
ENDATA
ELEMENTS      ALLINIT
TEMPORARIES
 R  SNX
 M  SIN
INDIVIDUALS
 T  SQR
 F                      X * X
 T  SQR2
 R  X         Y         1.0            Z         1.0
 F                      X * X
 T  SINSQR
 A  SNX                 SIN(X)
 F                      SNX * SNX
 T  PRODSQR
 A  XX                  X * X
 A  YY                  Y * Y
 F                      XX * YY
ENDATA
GROUPS        ALLINIT
INDIVIDUALS
 T  L2
 F                      GVAR * GVAR
ENDATA
"""

CONSTR = """\
NAME          CONSTR
 RE HALF                0.5
VARIABLES
    X1
    X2
    X3
GROUPS
 N  OBJ       X1        1.0            X2        -2.0
 E  CEQ       X1        1.0            X2        1.0
 L  CLE       X2        1.0            X3        3.0
 G  CGE       X3        1.0
 G  CNONE
CONSTANTS
    CONSTR    CEQ       1.0            CLE       4.0
    CONSTR    CGE       -1.0           CNONE     -2.0
RANGES
    CONSTR    CLE       2.5
BOUNDS
 FR CONSTR    'DEFAULT'
START POINT
    CONSTR    'DEFAULT' 0.5
ELEMENT TYPE
 EV SQ        V
 EV EXPP      V
 EP EXPP      S
ELEMENT USES
 T  Q1        SQ
 V  Q1        V                        X1
 T  Q3        SQ
 V  Q3        V                        X3
 T  EE        EXPP
 V  EE        V                        X2
 ZP EE        S                        HALF
GROUP USES
 E  OBJ       Q1                       Q3        0.5
 E  CEQ       EE        0.25
 E  CGE       Q1        -1.0
ENDATA
ELEMENTS      CONSTR
TEMPORARIES
 M  EXP
 M  COS
 R  W
INDIVIDUALS
 T  SQ
 F                      V * V
 T  EXPP
 A  W                   COS(S)
 F                      W * EXP(S * V)
ENDATA
"""


def extended_rosenbrock(n: int) -> str:
    """EXTROSNB in n variables (n even): sum over the pairs (x, y) =
    (X(I), Y(I)) of 100 (y - x^2)^2 + (x - 1)^2, the pairs declared in the
    order X1, Y1, X2, Y2, ... (those of tools/nlp_problems.py's
    ``ext_rosenbrock``), from (-1.2, 1, -1.2, 1, ...)."""
    if n % 2:
        raise ValueError("n must be even")
    return f"""\
NAME          EXTROSNB
 IE M                   {n // 2}
VARIABLES
 DO I         1                        M
 X  X(I)
 X  Y(I)
 ND
GROUPS
 DO I         1                        M
 XN A(I)      Y(I)      1.0
 XN A(I)      'SCALE'   0.01
 XN B(I)      X(I)      1.0
 ND
CONSTANTS
 DO I         1                        M
 X  EXTROSNB  B(I)      1.0
 ND
BOUNDS
 FR EXTROSNB  'DEFAULT'
START POINT
 DO I         1                        M
 XV EXTROSNB  X(I)      -1.2
 XV EXTROSNB  Y(I)      1.0
 ND
ELEMENT TYPE
 EV SQ        V
ELEMENT USES
 DO I         1                        M
 XT E(I)      SQ
 ZV E(I)      V                        X(I)
 ND
GROUP TYPE
 GV L2        GVAR
GROUP USES
 T  'DEFAULT' L2
 DO I         1                        M
 XE A(I)      E(I)      -1.0
 ND
ENDATA
ELEMENTS      EXTROSNB
INDIVIDUALS
 T  SQ
 F                      V * V
ENDATA
GROUPS        EXTROSNB
INDIVIDUALS
 T  L2
 F                      GVAR * GVAR
ENDATA
"""


TEXTS = {"CAMEL6": CAMEL6, "HART6": HART6, "ALLINIT": ALLINIT, "CONSTR": CONSTR}
