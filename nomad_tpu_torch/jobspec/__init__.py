"""HCL jobspec parsing (reference: jobspec/ — Parse at parse.go:27).

The counterpart of `nomad_tpu.jobspec`.
"""
from .hcl import Body, HCLParseError, parse_hcl
from .parse import (JobspecParseError, parse_duration_s, parse_file,
                    parse_job)

__all__ = ["parse_job", "parse_file", "parse_hcl", "parse_duration_s",
           "JobspecParseError", "HCLParseError", "Body"]
