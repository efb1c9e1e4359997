"""Program analysis for the port: the host-sync budget (the JAX
package's rule R2).  `transfers` counts the device -> host syncs of a
block of code (the sync debug mode on the card, patched chokepoints on
the CPU); `audit` holds every device search path to its stop tests + 1
readback a batch and to the port's own sync counters
(`python -m repro_torch.analysis`).  The reference's other rules walk
jaxprs and compiled HLO, and do not carry over."""
from repro_torch.analysis.transfers import (TransferCounter,
                                            count_transfers,
                                            measure_steady_state)

__all__ = ["TransferCounter", "count_transfers", "measure_steady_state"]
