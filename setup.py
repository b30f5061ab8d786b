"""Build config: the native fastops extension + the Python package.

Build in place:  python setup.py build_ext --inplace
The package degrades gracefully when the extension is absent
(visualcloze_tpu/utils/fastops.py falls back to numpy/PIL).
"""

import numpy as np
from setuptools import Extension, setup

setup(
    name="visualcloze_tpu",
    version="0.1.0",
    packages=[
        "visualcloze_tpu",
        "visualcloze_tpu.ops",
        "visualcloze_tpu.models",
        "visualcloze_tpu.transport",
        "visualcloze_tpu.parallel",
        "visualcloze_tpu.pipeline",
        "visualcloze_tpu.data",
        "visualcloze_tpu.training",
        "visualcloze_tpu.utils",
        "visualcloze_tpu_torch",
        "visualcloze_tpu_torch.ops",
        "visualcloze_tpu_torch.models",
        "visualcloze_tpu_torch.transport",
        "visualcloze_tpu_torch.pipeline",
    ],
    package_data={"visualcloze_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"]},
    ext_modules=[
        Extension(
            "visualcloze_tpu._fastops",
            sources=["visualcloze_tpu/csrc/fastops.c"],
            include_dirs=[np.get_include()],
            extra_compile_args=["-O3", "-fopenmp"],
            extra_link_args=["-fopenmp"],
        )
    ],
)
