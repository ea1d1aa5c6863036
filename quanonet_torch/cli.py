"""
Training/evaluation entry point of the port (counterpart of
quanonet_tpu/cli.py; reference main.py:16-125, CLI-compatible):

    python -m quanonet_torch.cli --operator Advection --model_type QuanONet \
        --net_size 40 2 20 2 --num_qubits 5 ... [--device cuda|cpu]

Runs on ``cuda`` unless ``--device cpu`` is given, and raises without a
card.  The reference's --quantum_backend / --classical_backend flags are
accepted so its reproduce scripts run unchanged; every value resolves to
the one engine.  ``--multi_seed`` trains its seeds as one packed model, or
one after another where the step needs it (multiseed.py).
``--num_devices N`` trains data-parallel over N ranks, ``--shard amp|pipe``
shards the circuit's state or pipelines its block chain over them
(parallel/): one rank a card on ``cuda`` (N beyond the card count raises;
``--share_device true`` puts the ranks on card 0 over gloo, to check the
code path on one card), gloo ranks sharing the host on the CPU; the Solver
starts the ranks, or
joins the world under ``torchrun --nproc_per_node N -m
quanonet_torch.cli ...``.
"""
import sys
import traceback

from quanonet_torch import resolve_device
from quanonet_torch.config import (
    get_base_parser, load_config, set_random_seed,
)


def main(argv=None):
    """Train and evaluate as the flags say; returns the Solver (its model
    holds the evaluated parameters), or with --multi_seed {seed: metrics}."""
    parser = get_base_parser()
    args = parser.parse_args(argv)
    config = load_config(args)
    device = resolve_device(config.get('device'))

    model_type = config['model_type']
    print("\n===========================================================")
    print(f" QuanONet PyTorch/CUDA Launcher | Model: {model_type} | "
          f"Operator: {config['operator']}")
    print(f" Engine: {config.get('engine', 'auto')} on {device} — "
          f"backend flags accepted for script compat: "
          f"q={config.get('quantum_backend')}, "
          f"c={config.get('classical_backend')}")
    print("===========================================================")

    set_random_seed(config.get('seed', 0))

    if config.get('multi_seed'):
        from quanonet_torch.multiseed import train_multi_seed
        try:
            result = train_multi_seed(config)
            print("\nExecution Finished Successfully.")
        except Exception as e:   # report and exit non-zero, as the reference
            print(f"\nExecution Failed: {e}")
            traceback.print_exc()
            sys.exit(1)
        return result

    from quanonet_torch.solver import Solver
    try:
        solver = Solver(config)
    except Exception as e:   # report and exit non-zero, as the reference
        print(f"Initialization Failed: {e}")
        traceback.print_exc()
        sys.exit(1)

    try:
        history = solver.train()
        solver.evaluate(history)
        print("\nExecution Finished Successfully.")
    except KeyboardInterrupt:
        print("\nInterrupted by user.")
    except SystemExit:
        raise
    except Exception as e:   # report and exit non-zero, as the reference
        print(f"\nExecution Failed: {e}")
        traceback.print_exc()
        sys.exit(1)
    return solver


if __name__ == "__main__":
    main()
