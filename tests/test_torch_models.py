"""Port parity: parsed mechanism and thermo tensors (batchreactor_tpu_torch
models/gas.py and models/thermo.py against the JAX package).

The parsers are host numpy code copied into the port, so every field must
be EQUAL, for the three vendored mechanisms, and ``from_numpy`` of the JAX
objects must rebuild the port's own parse.
"""

import os

import numpy as np
import pytest
import torch

import batchreactor_tpu as br
from batchreactor_tpu_torch.models.gas import (GAS_STATIC_FIELDS,
                                               GAS_TENSOR_FIELDS,
                                               GasMechanism,
                                               compile_gaschemistry)
from batchreactor_tpu_torch.models.thermo import (THERMO_TENSOR_FIELDS,
                                                  ThermoTable, create_thermo)

torch.set_num_threads(1)

MECHS = [("h2o2.dat", 9, 18), ("h2o2_n.dat", 12, 21), ("grimech.dat", 53, 325)]


def _jax_fields(obj, tensor_fields, static_fields):
    out = {f: np.asarray(getattr(obj, f)) for f in tensor_fields}
    out.update({f: getattr(obj, f) for f in static_fields})
    return out


@pytest.fixture(scope="module", params=MECHS, ids=[m[0] for m in MECHS])
def parsed(request, fixtures_dir):
    name, S, Rn = request.param
    path = os.path.join(fixtures_dir, name)
    therm = os.path.join(fixtures_dir, "therm.dat")
    gm_j = br.compile_gaschemistry(path)
    th_j = br.create_thermo(list(gm_j.species), therm)
    gm_t = compile_gaschemistry(path, device="cpu")
    th_t = create_thermo(list(gm_t.species), therm, device="cpu")
    return S, Rn, gm_j, th_j, gm_t, th_t


def test_gas_mechanism_fields_equal(parsed):
    S, Rn, gm_j, _, gm_t, _ = parsed
    assert (gm_t.n_species, gm_t.n_reactions) == (S, Rn)
    for f in GAS_TENSOR_FIELDS:
        a = getattr(gm_t, f)
        assert a.dtype == torch.float64 and a.device.type == "cpu", f
        np.testing.assert_array_equal(a.numpy(), np.asarray(getattr(gm_j, f)),
                                      err_msg=f)
    for f in GAS_STATIC_FIELDS:
        assert getattr(gm_t, f) == getattr(gm_j, f), f


def test_thermo_fields_equal(parsed):
    S, _, _, th_j, _, th_t = parsed
    assert th_t.n_species == S
    for f in THERMO_TENSOR_FIELDS:
        a = getattr(th_t, f)
        assert a.dtype == torch.float64, f
        np.testing.assert_array_equal(a.numpy(), np.asarray(getattr(th_j, f)),
                                      err_msg=f)
    assert th_t.species == th_j.species
    assert th_t.composition == th_j.composition


def test_from_numpy_of_jax_objects_equals_own_parse(parsed):
    _, _, gm_j, th_j, gm_t, th_t = parsed
    gm_x = GasMechanism.from_numpy(
        _jax_fields(gm_j, GAS_TENSOR_FIELDS, GAS_STATIC_FIELDS), "cpu")
    th_x = ThermoTable.from_numpy(
        _jax_fields(th_j, THERMO_TENSOR_FIELDS, ("species", "composition")),
        "cpu")
    for f in GAS_TENSOR_FIELDS:
        assert torch.equal(getattr(gm_x, f), getattr(gm_t, f)), f
    for f in GAS_STATIC_FIELDS:
        assert getattr(gm_x, f) == getattr(gm_t, f), f
    for f in THERMO_TENSOR_FIELDS:
        assert torch.equal(getattr(th_x, f), getattr(th_t, f)), f
    assert (th_x.species, th_x.composition) == (th_t.species,
                                                th_t.composition)


def test_to_device_keeps_fields(parsed):
    """``.to`` onto the same device is the identity; onto another device
    moves every tensor and keeps the static fields."""
    _, _, _, _, gm_t, th_t = parsed
    assert gm_t.to("cpu") is gm_t and th_t.to("cpu") is th_t
    gm_m = gm_t.to("meta")
    assert all(getattr(gm_m, f).device.type == "meta"
               for f in GAS_TENSOR_FIELDS)
    assert gm_m.species == gm_t.species and gm_m.int_stoich == gm_t.int_stoich
