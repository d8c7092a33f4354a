"""Post-hoc trajectory writers reproducing the reference's output files.

Port of ``batchreactor_tpu/io/writers.py`` (host numpy code, the same file
formats): ``gas_profile.dat/.csv`` with rows (t, T, p, rho, x_k) and, with
surface chemistry, ``surface_covg.dat/.csv`` with rows (t, T, theta_k),
placed next to the input XML.  ``.dat`` has a 10-wide right-aligned
tab-separated header and ``%.4e`` rows; ``.csv`` is comma-separated
full-precision floats.
"""

import os

import numpy as np

from ..utils.constants import R


def _write_dat(path, names, rows):
    with open(path, "w") as f:
        f.write("".join(f"{n:>10s}\t" for n in names) + "\n")
        for row in rows:
            f.write("".join(f"{v:.4e}\t" for v in row) + "\n")


def _write_csv(path, names, rows):
    with open(path, "w") as f:
        f.write(",".join(names) + "\n")
        for row in rows:
            f.write(",".join(repr(float(v)) for v in row) + "\n")


def trim_trajectory(t0, y0, ts, ys, n_saved, n_accepted, t_end, y_end):
    """(ts, ys, truncated) including the initial row, from one lane's saved
    rows (numpy).  If the solve accepted more steps than the buffer held,
    the true final state ``(t_end, y_end)`` is appended and ``truncated``
    is True — the last row is always the end of the integration."""
    n = int(n_saved)
    ts = np.concatenate([[float(t0)], np.asarray(ts[:n])])
    ys = np.concatenate([np.asarray(y0)[None, :], np.asarray(ys[:n])])
    truncated = int(n_accepted) > n
    if truncated:
        ts = np.concatenate([ts, [float(t_end)]])
        ys = np.concatenate([ys, np.asarray(y_end)[None, :]])
    return ts, ys, truncated


def gas_profile_rows(ts, ys, T, molwt, ng):
    """Rows (t, T, p, rho, x_1..x_S) from saved states y = rho_k."""
    rho_k = ys[:, :ng]
    rho = rho_k.sum(axis=1)
    moles = rho_k / molwt[None, :]   # molar concentration c_k [mol/m^3]
    x = moles / moles.sum(axis=1, keepdims=True)
    p = moles.sum(axis=1) * R * T    # = rho R T / Wbar, ideal gas
    return np.column_stack([ts, np.full_like(ts, T), p, rho, x])


def coverage_rows(ts, ys, T, ng):
    """Rows (t, T, theta_1..theta_Ss) from saved states [rho_k, theta_k]."""
    return np.column_stack([ts, np.full_like(ts, T), ys[:, ng:]])


def write_profiles(out_dir, species, ts, ys, T, molwt, surface_species=None):
    """Write gas_profile.{dat,csv} (and surface_covg.{dat,csv} when
    ``surface_species`` is given) into ``out_dir``; returns the paths.
    The coverage files carry the reference code's name,
    ``surface_covg``."""
    ng = len(species)
    gas_names = ["t", "T", "p", "rho"] + list(species)
    gas = gas_profile_rows(ts, ys, T, np.asarray(molwt), ng)
    paths = [
        os.path.join(out_dir, "gas_profile.dat"),
        os.path.join(out_dir, "gas_profile.csv"),
    ]
    _write_dat(paths[0], gas_names, gas)
    _write_csv(paths[1], gas_names, gas)
    if surface_species:
        cov_names = ["t", "T"] + list(surface_species)
        cov = coverage_rows(ts, ys, T, ng)
        cov_paths = [os.path.join(out_dir, "surface_covg.dat"),
                     os.path.join(out_dir, "surface_covg.csv")]
        _write_dat(cov_paths[0], cov_names, cov)
        _write_csv(cov_paths[1], cov_names, cov)
        paths += cov_paths
    return paths
