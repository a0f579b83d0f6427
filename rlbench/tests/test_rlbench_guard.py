import subprocess
import sys

from rlbench.run import forbidden_modules

from conftest import ROOT


def test_whole_top_level_names_are_compared():
    mods = {"renderloom_torch": 1, "renderloom_torch.ops": 1,
            "jaxtyping": 1, "torch": 1}
    assert forbidden_modules(mods) == []
    mods.update({"renderloom.ops.pose": 1, "jax": 1, "flax.linen": 1,
                 "jaxlib": 1})
    assert forbidden_modules(mods) == ["flax.linen", "jax", "jaxlib",
                                       "renderloom.ops.pose"]


def test_harness_and_reference_load_no_jax():
    code = ("import sys; sys.path.insert(0, %r); import rlbench.run, "
            "rlbench.serve, rlbench.train, rlbench.control, "
            "rlbench.reference.train.gan, rlbench.reference.eval.pipeline;"
            "from rlbench.run import forbidden_modules;"
            "assert not forbidden_modules(), forbidden_modules();"
            "assert not [m for m in sys.modules if m.split('.')[0] == "
            "'renderloom_torch']" % ROOT)
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300)


def test_a_run_without_the_program_fails(tmp_path):
    import shutil
    shutil.copytree(f"{ROOT}/rlbench", tmp_path / "rlbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(f"{ROOT}/BENCHMARK.json", tmp_path)
    res = subprocess.run(
        [sys.executable, "-m", "rlbench.run", "--workload",
         "hsm_fastpath_bf16.single", "--seed", "1", "--seconds", "1"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
