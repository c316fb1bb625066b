"""Shared inputs for the parity tests of the PyTorch port (``repro_torch``).

Both packages get the same instance: raw Table-5 class parameters are drawn
with ``np.random.default_rng(seed)`` and passed through each package's own
``derive``, with the capacity ``R`` computed once in numpy.  Values then
cross between the packages only as numpy arrays.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from repro.core import types as jt
from repro_torch import convert
from repro_torch.core import types as tt

RAGGED_NS = (5, 12, 3, 9)        # ragged: n_max never matches lane 0


def table5_raw(rng, n):
    """Raw class parameters per the paper's Table 5/6 design (numpy)."""
    rho_up = rng.uniform(5.0, 20.0, n)
    H_up = rng.integers(5, 21, n).astype(np.float64)
    cM = rng.integers(1, 5, n).astype(np.float64)
    cR = rng.integers(1, 5, n).astype(np.float64)
    m = rng.uniform(15000.0, 30000.0, n)
    nM = rng.integers(70, 1121, n).astype(np.float64)
    M_max = rng.uniform(16.0, 120.0, n)
    R_max = rng.uniform(15.0, 75.0, n)
    Sh1_max = rng.uniform(10.0, 30.0, n)
    Shtyp_max = rng.uniform(30.0, 150.0, n)
    D = rng.uniform(900.0, 1500.0, n)
    H_low = np.maximum(np.floor(0.8 * H_up), 1.0)
    return {"A": nM * (0.8 * M_max), "B": 64.0 * (0.8 * Shtyp_max + 0.8 * R_max),
            "E": M_max + R_max + Sh1_max + Shtyp_max - D, "cM": cM, "cR": cR,
            "H_up": H_up, "H_low": H_low, "m": m, "rho_up": rho_up}


def scenario_pair(rng, n, capacity_factor=0.95):
    """(JAX Scenario, port Scenario on the CPU) of one drawn instance."""
    raw = table5_raw(rng, n)
    rho_bar = float(rng.uniform(1.0, 1.6))
    sj = jt.derive(**{k: jnp.asarray(v) for k, v in raw.items()}, R=0.0,
                   rho_bar=rho_bar)
    st = tt.derive(**{k: torch.as_tensor(v) for k, v in raw.items()}, R=0.0,
                   rho_bar=rho_bar)
    R = capacity_factor * float(np.sum(np.asarray(sj.r_up)))
    return (sj.replace(R=jnp.asarray(R)),
            st.replace(R=torch.tensor(R, dtype=torch.float64)))


def scenario_pairs(seed, ns=RAGGED_NS, capacity_factor=0.95):
    rng = np.random.default_rng(seed)
    pairs = [scenario_pair(rng, n, capacity_factor) for n in ns]
    return [p[0] for p in pairs], [p[1] for p in pairs]


def batch_pair(seed, ns=RAGGED_NS, capacity_factor=0.95, n_max=None):
    """(JAX ScenarioBatch, port ScenarioBatch on the CPU), same instances."""
    sj, st = scenario_pairs(seed, ns, capacity_factor)
    return (jt.stack_scenarios(sj, n_max=n_max),
            tt.stack_scenarios(st, n_max=n_max, device="cpu"))


def leaves(container):
    """Dataclass / NamedTuple fields as a dict of numpy arrays."""
    if dataclasses.is_dataclass(container):
        names = [f.name for f in dataclasses.fields(container)]
    else:
        names = list(container._fields)
    return {k: np.asarray(getattr(container, k)) for k in names}


def to_port_batch(jbatch, dtype=None):
    """A JAX ScenarioBatch handed to the port through numpy."""
    return convert.batch_from_numpy(leaves(jbatch.scenarios),
                                    np.asarray(jbatch.mask),
                                    np.asarray(jbatch.n_classes),
                                    device="cpu", dtype=dtype)


def np_(x):
    """numpy view of a torch tensor or a JAX array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_rel_close(got, want, rel, label=""):
    """max |got - want| <= rel * max |want|, for tensors or arrays of any
    float dtype (compared in f32)."""
    got = (got.to(torch.float32).numpy() if isinstance(got, torch.Tensor)
           else np.asarray(got, np.float32))
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{label}: max err {err} > {rel} x {scale}"


def event_record(ev):
    """A JAX stream event as the plain record ``convert.event_from_record``
    takes: its class name under ``kind`` and its fields as Python scalars."""
    rec = {"kind": type(ev).__name__}
    for key, value in vars(ev).items():
        rec[key] = ({k: float(v) for k, v in value.items()}
                    if isinstance(value, dict) else value)
    return rec


def port_events(events):
    """JAX stream events handed to the port as records."""
    return [convert.event_from_record(event_record(ev)) for ev in events]


def window_pair(seed, ns=(5, 8, 3, 6), n_max=None, capacity_factor=1.2,
                growth_factor=2.0):
    """(JAX AdmissionWindow, port AdmissionWindow on the CPU) over the same
    drawn instances."""
    from repro.core import streaming as js
    from repro_torch.core import streaming as ts
    sj, st = scenario_pairs(seed, ns, capacity_factor)
    return (js.AdmissionWindow(sj, n_max=n_max, growth_factor=growth_factor),
            ts.AdmissionWindow(st, n_max=n_max, growth_factor=growth_factor))
