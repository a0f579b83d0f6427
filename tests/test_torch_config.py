"""The PyTorch port's copy of the config loaders against the JAX
package's: the shipped yaml files, and a dict in the reference's flat
key layout, load to equal values in every field the port keeps."""

import dataclasses
import os

import pytest

import renderloom.core.config as JC
import renderloom_torch.core.config as TC

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _same_fields(port, ref, path="cfg"):
    """Every field of the port's dataclass equals the JAX one's."""
    for f in dataclasses.fields(port):
        a, b = getattr(port, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(a):
            _same_fields(a, b, f"{path}.{f.name}")
        else:
            assert a == b, (f"{path}.{f.name}", a, b)


@pytest.mark.parametrize("name,loader", [
    ("motion.yaml", "load_motion_config"),
    ("smoke_motion.yaml", "load_motion_config"),
    ("hsm.yaml", "load_renderer_config"),
    ("smoke_hsm.yaml", "load_renderer_config"),
])
def test_yaml_loads_as_in_jax(name, loader):
    path = os.path.join(ROOT, "configs", name)
    _same_fields(getattr(TC, loader)(path), getattr(JC, loader)(path))


def test_flat_reference_layout_loads_as_in_jax():
    raw = {"model_width": 96, "model_height": 64, "load_width": 128,
           "load_height": 80, "gauss_sigma": 4.0, "compute_dtype": "float32",
           "gen": {"num_filters": 8, "activation_norm_params":
                   {"kernel_size": 3}, "mask": {"num_res_blocks": 1}}}
    port = TC.renderer_config_from_dict(raw)
    assert port.gen.spade_kernel_size == 3 and port.data.load_width == 128
    _same_fields(port, JC.renderer_config_from_dict(raw))


@pytest.mark.parametrize("name", ["motion.yaml", "smoke_motion.yaml"])
def test_motion_dataset_config_loads_as_in_jax(name):
    path = os.path.join(ROOT, "configs", name)
    port = TC.load_motion_config(path).dataset
    assert isinstance(port, TC.MotionDatasetConfig)
    _same_fields(port, JC.load_motion_config(path).dataset, "dataset")


def test_flat_motion_dataset_keys_load_as_in_jax():
    raw = {"data_root": "stats", "focal": 5.0, "openpose_scale": 300.0,
           "dataset": {"focal": 6.0, "camera_project": "orthogonal"}}
    port = TC.motion_config_from_dict(raw).dataset
    assert (port.data_root, port.focal, port.openpose_scale,
            port.camera_project) == ("stats", 6.0, 300.0, "orthogonal")
    _same_fields(port, JC.motion_config_from_dict(raw).dataset, "dataset")
