"""python -m numbskull_tpu_torch (reference: numbskull/__main__.py)."""

from numbskull_tpu_torch.numbskull import main

if __name__ == "__main__":
    main()
