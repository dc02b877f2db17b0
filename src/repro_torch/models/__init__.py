"""The model stack: configs data, the parameter tables, the layers (attention, Mamba, RWKV6, MoE FFN), the context-parallel carries and the assembled ``Model``."""
