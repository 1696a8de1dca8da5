"""Package build for mpibwa-tpu.

Python + JAX for the device path; the native host runtime (C: finalization,
fixmate, SA-IS index builder) ships as source in mpibwa_tpu/native/ and is
compiled on demand by native/__init__.py with the system compiler (no
compiler at runtime -> exact Python fallbacks).
"""

from setuptools import find_packages, setup

setup(
    name="mpibwa-tpu",
    version="0.1.0",
    description="BWA-MEM-class read aligner on a GPU (JAX/XLA)",
    packages=find_packages(include=["mpibwa_tpu", "mpibwa_tpu.*"]),
    package_data={"mpibwa_tpu.native": ["*.c", "*.h"],
                  "mpibwa_tpu.io": ["hcc1187c_quals.txt.gz"]},
    python_requires=">=3.10",
    install_requires=["numpy", "jax"],
    entry_points={
        "console_scripts": [
            "mpibwa-tpu=mpibwa_tpu.cli:main",
        ]
    },
)
