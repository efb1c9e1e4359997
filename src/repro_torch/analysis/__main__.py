"""`python -m repro_torch.analysis [--device cpu] [--json out] [--sites]`:
the host-sync budget audit; exits 1 if a path breaks its budget."""
import sys

from repro_torch.analysis.audit import main

if __name__ == "__main__":
    sys.exit(main())
