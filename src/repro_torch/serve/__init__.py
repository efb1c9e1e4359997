"""repro_torch.serve: the serving tier, length-bucket dynamic batching
under live ingestion over the port's engine (the port of `repro.serve`)."""
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.server import (AdmissionError, ServeConfig,
                                      ServerClosed, Ticket, UlisseServer,
                                      follow)

__all__ = ["AdmissionError", "ServeConfig", "ServeMetrics",
           "ServerClosed", "Ticket", "UlisseServer", "follow"]
