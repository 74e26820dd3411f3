"""qiddm_tpu_torch never imports JAX or the JAX package: the machine with
the card has no JAX."""

import pathlib
import subprocess
import sys

PKG = pathlib.Path(__file__).resolve().parents[1] / "qiddm_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "qiddm_tpu")


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_importing_every_module_leaves_jax_out():
    mods = list(_modules())
    assert {"qiddm_tpu_torch.sim.gate_kernel", "qiddm_tpu_torch.sim.wide",
            "qiddm_tpu_torch.sim.wide_kernel",
            "qiddm_tpu_torch.tools.vpu_ceiling",
            "qiddm_tpu_torch.tools.wide_probe",
            "qiddm_tpu_torch.tools.probe_kernels",
            "qiddm_tpu_torch.tools.unet_precision",
            "qiddm_tpu_torch.nn.unet", "qiddm_tpu_torch.nn.qconv",
            "qiddm_tpu_torch.nn.conv", "qiddm_tpu_torch.nn.utils",
            "qiddm_tpu_torch.sweep", "qiddm_tpu_torch.profiler",
            "qiddm_tpu_torch.cli.fashion_exm",
            "qiddm_tpu_torch.cli.emnist_exm",
            "qiddm_tpu_torch.cli.rebuttal_common",
            "qiddm_tpu_torch.cli.bloodmnist",
            "qiddm_tpu_torch.cli.PneumoniaMNIST",
            "qiddm_tpu_torch.cli.fruit_360", "qiddm_tpu_torch.cli.logo2kplus",
            "qiddm_tpu_torch.cli.mnist_ray",
            "qiddm_tpu_torch.cli.fashion_ray", "qiddm_tpu_torch.export",
            "qiddm_tpu_torch.sim.ops", "qiddm_tpu_torch.native",
            "qiddm_tpu_torch.native.qsim", "qiddm_tpu_torch.sim.qasm",
            "qiddm_tpu_torch.sim.gradients"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=PKG.parent,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_source_names_jax_or_the_jax_package():
    offenders = [str(p) for p in PKG.rglob("*.py")
                 if "import jax" in p.read_text()
                 or "qiddm_tpu." in p.read_text()]
    assert offenders == []
    # the native engine is the port's own copy, built from its own source
    assert (PKG / "native" / "qsim.cpp").is_file()
    assert "qsim.cpp" in (PKG / "native" / "qsim.py").read_text()
