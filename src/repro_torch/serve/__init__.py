from .engine import PagedServingEngine, Request, ServingEngine
from .metrics import ServingMetrics
from .pool import KVPool, PageAllocator, PoolExhausted

__all__ = ["ServingEngine", "PagedServingEngine", "Request",
           "ServingMetrics", "KVPool", "PageAllocator", "PoolExhausted"]
