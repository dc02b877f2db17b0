"""Scan-consuming model pieces: configs data, the SSM chunk scan, the context-parallel carry and MoE dispatch accounting."""
