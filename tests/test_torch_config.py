"""The PyTorch package's VIOConfig is the JAX package's, field for field."""
import dataclasses
import glob
import os

import pytest
import yaml

from ekf_vio_tpu import config as jconfig
from ekf_vio_tpu_torch import config


def test_fields_and_defaults_match():
    ref = {f.name: f.default for f in dataclasses.fields(jconfig.VIOConfig)}
    got = {f.name: f.default for f in dataclasses.fields(config.VIOConfig)}
    assert list(got) == list(ref)
    assert got == ref
    assert config.VIOConfig() == config.VIOConfig(**ref)


def test_layout_constants_match():
    for name in ("POS", "QUAT", "VEL", "OMEGA", "ACCEL", "BIAS_ACC",
                 "BIAS_GYRO", "BASE_STATE_SIZE"):
        assert getattr(config, name) == getattr(jconfig, name)
    for n in (32, 128, 503):
        assert (config.VIOConfig(max_features=n).state_dim
                == jconfig.VIOConfig(max_features=n).state_dim)


def test_validation_matches():
    cfg = config.VIOConfig(max_features=32, num_features=100)
    assert cfg.num_features == 32
    for bad in (dict(joseph_form="x"), dict(klt_covariance="x")):
        with pytest.raises(ValueError):
            config.VIOConfig(**bad)
        with pytest.raises(ValueError):
            jconfig.VIOConfig(**bad)


def test_from_dict_and_yaml(tmp_path):
    d = {"max_features": 64, "fast_threshold": 30, "not_a_field": 1}
    assert (dataclasses.asdict(config.VIOConfig.from_dict(d))
            == dataclasses.asdict(jconfig.VIOConfig.from_dict(d)))
    p = tmp_path / "profile.yaml"
    p.write_text("max_features: 64\nmin_new_feature_dist: 8.0\n")
    assert (dataclasses.asdict(config.VIOConfig.from_yaml(str(p)))
            == dataclasses.asdict(jconfig.VIOConfig.from_yaml(str(p))))
    assert config.VIOConfig().replace(kill_pad=3).kill_pad == 3


PROFILES = sorted(glob.glob(os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs",
    "*.yaml")))


@pytest.mark.parametrize("path", PROFILES, ids=os.path.basename)
def test_every_profile_loads_as_in_jax(path):
    """The port's one YAML parser (``parse_flat_yaml``) reads each profile
    in configs/ as ``yaml.safe_load`` does, and ``from_yaml`` gives the
    JAX package's config."""
    with open(path) as f:
        text = f.read()
    assert config.parse_flat_yaml(text) == (yaml.safe_load(text) or {})
    assert (dataclasses.asdict(config.VIOConfig.from_yaml(path))
            == dataclasses.asdict(jconfig.VIOConfig.from_yaml(path)))


def test_flat_yaml_scalars_match_safe_load():
    text = ("# a profile\nuse_imu: true\nsquare_root_form: False\n"
            "max_features: 64   # slots\nklt_eps: 0.01\nq_bias: 1.0e-3\n"
            "klt_covariance: 'sample'\njoseph_form: product\n\n")
    assert config.parse_flat_yaml(text) == yaml.safe_load(text)
    with pytest.raises(ValueError):
        config.parse_flat_yaml("a:\n  nested: 1\n")
