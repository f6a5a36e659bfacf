"""A port config against the JAX package's: equal on every field of the
JAX dataclass, and every field only the port has (latent attention, the
sigmoid router) at its default, so that it changes nothing there."""
import dataclasses


def assert_config_equal_jax(tcfg, jcfg) -> None:
    jax_fields = [f.name for f in dataclasses.fields(jcfg)]
    mine = dataclasses.asdict(tcfg)
    assert {k: mine[k] for k in jax_fields} == dataclasses.asdict(jcfg)
    for f in dataclasses.fields(tcfg):
        if f.name not in jax_fields:
            assert getattr(tcfg, f.name) == f.default, f.name
