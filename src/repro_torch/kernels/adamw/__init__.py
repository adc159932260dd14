from .ops import norm, table, update
