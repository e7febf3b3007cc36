"""Packaging (python/setup.py.in:1-30 parity): `pip install -e .` gives
an importable paddle_tpu plus the `paddle` CLI entry point
(paddle/scripts/submit_local.sh.in dispatcher)."""

import os
import re

from setuptools import find_packages, setup


def _version():
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "paddle_tpu", "version.py")) as f:
        m = re.search(r"__version__\s*=\s*['\"]([^'\"]+)['\"]", f.read())
    return m.group(1) if m else "0.0.0"


setup(
    name="paddle-tpu",
    version=_version(),
    description="TPU-native deep learning framework with the PaddlePaddle "
                "v2 API surface (JAX/XLA compute, native C++ runtime)",
    packages=find_packages(include=["paddle_tpu", "paddle_tpu.*",
                                    "paddle_tpu_torch", "paddle_tpu_torch.*"]),
    package_data={
        "paddle_tpu.native": ["*.cc", "*.h", "Makefile"],
        "paddle_tpu_torch": ["csrc/*.cu*"],
    },
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "numpy",
    ],
    entry_points={
        "console_scripts": [
            "paddle=paddle_tpu.cli:main",
        ],
    },
)
