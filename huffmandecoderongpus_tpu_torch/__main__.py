"""`python -m huffmandecoderongpus_tpu_torch` — the command-line entry point."""

from huffmandecoderongpus_tpu_torch.harness.cli import main

if __name__ == "__main__":
    main()
