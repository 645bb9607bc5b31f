"""``python -m ace_tpu_torch.evaluator <yaml> [--override ...] [--device cpu]``
(port of ace_tpu/evaluator.py)."""

from ace_tpu_torch.inference.evaluator import main

if __name__ == "__main__":
    main()
