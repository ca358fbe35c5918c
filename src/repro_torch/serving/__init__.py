from repro_torch.serving.engine import (InFlightBatch, MicroBatcher,
                                        PreparedBatch, Request, Result,
                                        RetrievalEngine)

__all__ = ["InFlightBatch", "MicroBatcher", "PreparedBatch", "Request",
           "Result", "RetrievalEngine"]
