"""Physical constants and atomic masses.

A copy of ``batchreactor_tpu/utils/constants.py``: the port imports nothing
of the JAX package, so it keeps its own copy of this table.  The gas
constant (CODATA 2002) and the classic CHEMKIN atomic-mass table are the
values the JAX package calibrated against the reference's golden
``gas_profile.csv`` (its initial density pins p*M/(R*T) to ~6e-7).
"""

# Universal gas constant [J / (mol K)].
R = 8.314472

# cal -> J (thermochemical calorie); CHEMKIN-II activation energies are cal/mol.
CAL_TO_J = 4.184

# Standard-state pressure for NASA-7 thermodynamics [Pa] (1 atm).
P_ATM = 101325.0

# Avogadro number [1/mol], Boltzmann [J/K].
NA = 6.02214076e23
KB = 1.380649e-23

# Atomic masses [g/mol], classic CHEMKIN table.
ATOMIC_MASS = {
    "H": 1.00797,
    "D": 2.014102,
    "HE": 4.0026,
    "C": 12.01115,
    "N": 14.0067,
    "O": 15.9994,
    "F": 18.998403,
    "NE": 20.179,
    "NA": 22.98977,
    "MG": 24.305,
    "AL": 26.98154,
    "SI": 28.0855,
    "P": 30.97376,
    "S": 32.064,
    "CL": 35.453,
    "AR": 39.948,
    "K": 39.0983,
    "CA": 40.08,
    "FE": 55.847,
    "NI": 58.71,
    "CU": 63.546,
    "ZN": 65.38,
    "BR": 79.904,
    "KR": 83.8,
    "RH": 102.9055,
    "PD": 106.4,
    "AG": 107.868,
    "PT": 195.09,
    "AU": 196.9665,
    "E": 5.48579903e-4,
}
