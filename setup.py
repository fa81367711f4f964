from setuptools import find_packages, setup

setup(
    name="iterative-solver-tpu",
    version="0.1.0",
    description="TPU-native subspace iterative-solver framework (JAX/XLA/Pallas)",
    packages=find_packages(include=["iterative_solver_tpu*", "iterative_solver_torch*"]),
    package_data={"iterative_solver_torch.ops.kernels": ["csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=["jax", "numpy", "scipy"],
    extras_require={"torch": ["torch"]},
)
