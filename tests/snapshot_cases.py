"""The port's serving metrics (snapshot schema v6) held to the JAX
engine's (schema v4): every v4 field exactly, and the port's extra
fields exactly the ones v5 and v6 add."""

#: what schemas v5 and v6 add to v4, by group
PORT_FIELDS = {
    "counters": {"gate_verifications", "gate_us", "pack_us",
                 "prefill_model_us", "decode_model_us", "token_wait_us",
                 "decode_graph_replays", "decode_graph_captures"},
    "latency": {"queue_wait_us", "ttft_us", "tpot_us"},
}


def assert_v4_group_matches(group, got, want):
    """``got`` (a group of a port v6 snapshot, such as its counters)
    equals ``want`` (the JAX v4 one) at every v4 key, and holds exactly
    the port's keys besides."""
    assert set(got) - set(want) == PORT_FIELDS.get(group, set()), group
    assert {k: got[k] for k in want} == want, group


def assert_v4_fields_match(got, want):
    """``got`` (a port v6 snapshot) equals ``want`` (a JAX v4 one) in
    every v4 field, and holds exactly the port's fields besides."""
    assert (got["schema"], want["schema"]) == (6, 4)
    assert set(got) == set(want)
    for group, value in want.items():
        if isinstance(value, dict):
            assert_v4_group_matches(group, got[group], value)
        elif group != "schema":
            assert got[group] == value, group
