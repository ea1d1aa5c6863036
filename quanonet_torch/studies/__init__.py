"""
The paper's beyond-reference studies on the port (counterparts of
scripts/noise_robustness_study.py and scripts/hardware_training_study.py):

    python -m quanonet_torch.studies.noise_robustness [--device cuda|cpu]
    python -m quanonet_torch.studies.hardware_training [--quick]
        [--device cuda|cpu]

Both train Q2 Antideriv through the port's Solver on the card (its
kernels: the block chain B1f/B1b and the compile B4f/B4b) and write
``docs/*_torch.csv`` in the JAX scripts' layout, never the JAX files.
"""
