"""The port's wire format against tests/test_wire.py: spec round trips,
loud rejection of unknown plugins/params and malformed documents, the
introspection registry — plus specs written by the JAX package's
``to_spec`` (v1, and a v2 streaming spec) loading in the port and giving
the same chain."""
import json

import numpy as np
import pytest

import repro.core as R
import repro.service as JS
import repro.tomo as JT

from repro_torch.core import CudaTransport, LambdaFilter, PluginRunner, \
    ProcessList
from repro_torch.core.process_list import ProcessListError
from repro_torch.service import (WireError, chain_signature, from_spec,
                                 register_plugin, registered_plugins,
                                 registry_spec, to_spec)
from repro_torch.service.wire import LOCAL_PARAMS, _valid_params
from repro_torch.tomo import SyntheticTomoLoader, standard_chain

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:                          # pragma: no cover
    HAVE_HYPOTHESIS = False

CHAIN_TOL = {"rtol": 1e-3, "atol": 1e-4}


def test_round_trip_preserves_chain_signature():
    pl = standard_chain(n_det=24, n_angles=24, n_rows=1, paganin=True)
    spec = to_spec(pl)
    json.dumps(spec)
    pl2 = from_spec(spec)
    assert chain_signature(pl) == chain_signature(pl2)
    assert pl2.check() == pl.check()


def test_round_trip_is_stable():
    spec = to_spec(standard_chain(n_det=16, n_angles=16))
    assert to_spec(from_spec(spec)) == spec


def test_from_spec_accepts_bare_plugin_list():
    spec = to_spec(standard_chain(n_det=16, n_angles=16))
    pl = from_spec(spec["plugins"])
    assert chain_signature(pl) == chain_signature(
        standard_chain(n_det=16, n_angles=16))


def test_unknown_plugin_rejected_loudly():
    with pytest.raises(WireError, match="unknown plugin 'warp_drive'"):
        from_spec({"plugins": [{"plugin": "warp_drive"}]})
    with pytest.raises(WireError, match="synthetic_tomo_loader"):
        from_spec({"plugins": [{"plugin": "warp_drive"}]})


def test_unknown_param_rejected_loudly():
    spec = {"plugins": [
        {"plugin": "synthetic_tomo_loader",
         "params": {"n_det": 16, "warp": 9},
         "out_datasets": ["tomo"]}]}
    with pytest.raises(WireError, match=r"unknown params \['warp'\]"):
        from_spec(spec)


@pytest.mark.parametrize("spec", [
    42, "nope", {}, {"plugins": []}, {"plugins": [7]},
    {"plugins": [{"params": {}}]},
    {"version": 99, "plugins": [{"plugin": "fbp_recon"}]},
    {"plugins": [{"plugin": "fbp_recon", "params": ["not", "a", "dict"]}]},
    {"plugins": [{"plugin": "fbp_recon", "in_datasets": "tomo"}]},
    {"version": 1, "streaming": True, "plugins": [{"plugin": "fbp_recon"}]},
])
def test_malformed_specs_rejected(spec):
    with pytest.raises(WireError):
        from_spec(spec)


def test_to_spec_rejects_unregistered_plugin():
    pl = ProcessList()
    pl.add(SyntheticTomoLoader, params={"n_det": 16, "n_angles": 16},
           out_datasets=("tomo",))
    pl.add(LambdaFilter, params={"fn": lambda b: b},
           in_datasets=("tomo",), out_datasets=("tomo",))
    with pytest.raises(WireError, match="not wire-registered"):
        to_spec(pl)


def test_register_plugin_conflict_rejected():
    class Impostor(SyntheticTomoLoader):
        name = "synthetic_tomo_loader"
    with pytest.raises(WireError, match="already registered"):
        register_plugin(Impostor)
    register_plugin(SyntheticTomoLoader)
    assert registered_plugins()["synthetic_tomo_loader"] \
        is SyntheticTomoLoader


def test_structural_errors_still_caught_by_check():
    spec = {"plugins": [
        {"plugin": "synthetic_tomo_loader", "params": {"n_det": 16},
         "out_datasets": ["tomo"]}]}
    pl = from_spec(spec)
    with pytest.raises(ProcessListError, match="saver"):
        pl.check()


def test_registry_spec_is_jsonable_introspection():
    reg = registry_spec()
    json.dumps(reg)
    loader = reg["synthetic_tomo_loader"]
    assert loader["params"]["seed"]["data_param"] is True
    assert loader["params"]["n_det"] == {"default": 64,
                                         "data_param": False,
                                         "sweepable": False}
    assert loader["n_in_datasets"] == 0
    recon = reg["fbp_recon"]
    assert recon["params"]["use_pallas"]["default"] is True
    assert recon["n_out_datasets"] == 1
    assert reg["sinogram_filter"]["params"]["cutoff"]["sweepable"] is True
    assert reg["ring_removal"]["params"]["strength"]["sweepable"] is True
    assert reg["paganin_filter"]["params"]["tau"]["sweepable"] is True


def test_registry_matches_jax_registry():
    """Same wire names as the JAX package's default registry (its tomo
    plugins; other tests may register more there), and every parameter
    it declares is declared here with the same default; the port's
    loader adds one, ``device``, and its Paganin filter two, the edge
    pads ``pad_y`` and ``pad_x``."""
    mine = registry_spec()
    ref = {name: cls.param_spec()
           for name, cls in JS.registered_plugins().items()
           if cls.__module__ == "repro.tomo.plugins"}
    assert sorted(mine) == sorted(ref)
    added = {"synthetic_tomo_loader": {"device"},
             "paganin_filter": {"pad_y", "pad_x"}}
    for name, spec in ref.items():
        extra = set(mine[name]["params"]) - set(spec["params"])
        assert extra == added.get(name, set())
        for k, v in spec["params"].items():
            assert mine[name]["params"][k] == v, (name, k)


# ---------------------------------- specs written by the JAX package
def _run_port(pl, scan):
    pl.entries[0].params.update(scan=scan, device="cpu")
    r = PluginRunner(pl, CudaTransport("cpu"))
    return r.transport.read(r.run()["recon"])


def _run_jax(pl, scan):
    pl.entries[0].params["scan"] = scan
    r = R.PluginRunner(pl, R.InMemoryTransport())
    return np.asarray(r.transport.read(r.run()["recon"]))


def test_jax_v1_spec_loads_as_the_same_chain():
    """``repro`` ``to_spec(standard_chain)`` -> the port's ``from_spec``:
    the same entries (the port writes the spec back unchanged), and on
    the same scan the same reconstruction within the chain bound."""
    jpl = JT.standard_chain(n_det=32, n_angles=24, n_rows=2, paganin=True,
                            use_pallas=False)
    spec = json.loads(json.dumps(JS.to_spec(jpl)))
    pl = from_spec(spec)
    assert to_spec(pl) == spec
    assert [e.cls.name for e in pl.entries] == \
        [e.cls.name for e in jpl.entries]
    assert chain_signature(pl) == chain_signature(from_spec(to_spec(pl)))
    scan = JT.simulate_raw_scan(JT.phantom_stack(32, 2),
                                JT.ParallelGeometry(24, 32, 2), seed=4)
    got = _run_port(pl, scan)
    want = _run_jax(JS.from_spec(spec), scan)
    np.testing.assert_allclose(got, want, **CHAIN_TOL)


def test_jax_v2_streaming_spec_loads_streaming():
    jpl = JS.from_spec({"version": 2, "streaming": True,
                        "plugins": JS.to_spec(JT.standard_chain(
                            n_det=16, n_angles=12, n_rows=1))["plugins"]})
    spec = JS.to_spec(jpl)
    assert spec["version"] == 2 and spec["streaming"] is True
    pl = from_spec(json.loads(json.dumps(spec)))
    assert getattr(pl, "streaming", False) is True
    assert to_spec(pl) == spec
    # the flag is not part of the chain signature: a streamed chain
    # shares steps and checkpoints with its batch twin
    batch = from_spec({**spec, "version": 1, "streaming": False})
    assert chain_signature(batch) == chain_signature(pl)


def test_port_spec_loads_in_the_jax_package_and_back():
    """The loader's ``device`` stays off the wire (where a job runs is
    the service's choice): a spec the port writes loads in the JAX
    package's ``from_spec`` and gives the same spec back, and the port
    loads the JAX package's spec on the device its caller names."""
    spec = to_spec(standard_chain(n_det=16, n_angles=16, device="cpu"))
    assert "device" not in spec["plugins"][0]["params"]
    assert JS.to_spec(JS.from_spec(spec)) == spec
    jspec = JS.to_spec(JT.standard_chain(n_det=16, n_angles=16))
    pl = from_spec(jspec, device="cpu")
    assert pl.entries[0].params["device"] == "cpu"
    assert to_spec(pl) == jspec == spec


# ------------------------------------------------- property tests
if HAVE_HYPOTHESIS:
    _REG = registered_plugins()
    _WIRE_NAMES = sorted(_REG)
    _DS_NAMES = ("a", "b", "c", "d")

    _json_values = st.recursive(
        st.none() | st.booleans() | st.integers(-2 ** 31, 2 ** 31)
        | st.floats(allow_nan=False, allow_infinity=False)
        | st.text(max_size=8),
        lambda kids: st.lists(kids, max_size=3)
        | st.dictionaries(st.text(max_size=4), kids, max_size=3),
        max_leaves=6)

    @st.composite
    def _valid_entries(draw):
        name = draw(st.sampled_from(_WIRE_NAMES))
        entry = {"plugin": name}
        # the wire's parameters: where a plugin computes stays off it
        declared = sorted(set(_REG[name].parameters) - set(LOCAL_PARAMS))
        if declared:
            params = draw(st.dictionaries(st.sampled_from(declared),
                                          _json_values, max_size=3))
            if params:
                entry["params"] = params
        for key in ("in_datasets", "out_datasets"):
            names = draw(st.lists(st.sampled_from(_DS_NAMES),
                                  max_size=2, unique=True))
            if names:
                entry[key] = names
        return entry

    @st.composite
    def _valid_specs(draw):
        return {"version": 1,
                "plugins": draw(st.lists(_valid_entries(),
                                         min_size=1, max_size=4))}

    @given(spec=_valid_specs())
    @settings(max_examples=60, deadline=None)
    def test_property_valid_spec_round_trips(spec):
        pl = from_spec(spec)
        again = to_spec(pl)
        assert again == spec
        assert chain_signature(from_spec(again)) == chain_signature(pl)

    @given(name=st.text(min_size=1, max_size=12).filter(
        lambda s: s not in registered_plugins()))
    @settings(max_examples=40, deadline=None)
    def test_property_unknown_plugin_lists_alternatives(name):
        with pytest.raises(WireError) as ei:
            from_spec({"plugins": [{"plugin": name}]})
        msg = str(ei.value)
        assert "unknown plugin" in msg
        for known in _WIRE_NAMES:
            assert known in msg

    @given(data=st.data())
    @settings(max_examples=40, deadline=None)
    def test_property_unknown_param_lists_valid(data):
        wire = data.draw(st.sampled_from(_WIRE_NAMES))
        valid = _valid_params(_REG[wire])
        bad = data.draw(st.text(min_size=1, max_size=10).filter(
            lambda s: s not in valid))
        with pytest.raises(WireError) as ei:
            from_spec({"plugins": [{"plugin": wire,
                                    "params": {bad: 1}}]})
        msg = str(ei.value)
        assert "unknown params" in msg and "valid:" in msg
        for p in sorted(valid):
            assert p in msg

    # versions 1 and 2 are both valid (2 is the streaming spec), so the
    # malformed versions exclude both
    _malformed_specs = st.one_of(
        st.integers(), st.text(max_size=6), st.booleans(),
        st.just({}),
        st.just({"plugins": []}),
        st.just({"plugins": [7]}),
        st.just({"plugins": [{"params": {}}]}),
        st.builds(
            lambda v: {"version": v,
                       "plugins": [{"plugin": "fbp_recon"}]},
            st.one_of(st.integers().filter(lambda v: v not in (1, 2)),
                      st.just("1"))),
        st.just({"plugins": [{"plugin": "fbp_recon",
                              "params": ["not", "a", "dict"]}]}),
        st.just({"plugins": [{"plugin": "fbp_recon",
                              "in_datasets": "tomo"}]}),
        st.just({"plugins": [{"plugin": "fbp_recon",
                              "out_datasets": [1, 2]}]}),
        st.just({"plugins": [{"plugin": "synthetic_tomo_loader",
                              "params": {"seed": {1, 2}}}]}),
    )

    @given(spec=_malformed_specs)
    @settings(max_examples=60, deadline=None)
    def test_property_malformed_specs_always_raise(spec):
        with pytest.raises(WireError):
            from_spec(spec)
