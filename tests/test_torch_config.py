"""The PyTorch package's VIOConfig is the JAX package's, field for field."""
import dataclasses

import pytest

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
