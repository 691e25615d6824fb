"""Quantization scheme configuration (PyTorch port of ``aqlm_tpu.config``).

A weight ``W [out_features, in_features]`` is cut into groups of
``out_group_size x in_group_size``; each group is encoded by
``num_codebooks`` codes, each indexing a codebook of
``2**nbits_per_codebook`` vectors. ``"2x8g8"`` = 2 codebooks of 8 bits,
in_group_size 8.

The dataclass is re-declared here rather than imported: the JAX module
imports ``jax.numpy`` for ``code_dtype``, and this package imports no JAX.
"""

from __future__ import annotations

import dataclasses
import re

import torch

__all__ = ["AqlmScheme", "SCHEME_1X16", "SCHEME_2X8", "SCHEME_8X8", "SCHEME_1X8"]

_SCHEME_RE = re.compile(r"^(\d+)x(\d+)(?:g(\d+))?$")


@dataclasses.dataclass(frozen=True)
class AqlmScheme:
    """Static, hashable description of one additive-quantization scheme."""

    num_codebooks: int = 1
    nbits_per_codebook: int = 16
    in_group_size: int = 8
    out_group_size: int = 1

    def __post_init__(self):
        if self.num_codebooks < 1:
            raise ValueError("num_codebooks must be >= 1")
        if not (1 <= self.nbits_per_codebook <= 16):
            raise ValueError("nbits_per_codebook must be in [1, 16]")
        if self.in_group_size < 1 or self.out_group_size < 1:
            raise ValueError("group sizes must be >= 1")

    @property
    def codebook_size(self) -> int:
        return 2 ** self.nbits_per_codebook

    @property
    def group_numel(self) -> int:
        return self.in_group_size * self.out_group_size

    @property
    def code_dtype(self) -> torch.dtype:
        """Smallest unsigned dtype that holds one code: 8-bit codes are
        uint8 and must be read unsigned (a code of 200 is row 200, not -56)."""
        if self.nbits_per_codebook <= 8:
            return torch.uint8
        return torch.uint16

    def code_bits_per_weight(self) -> float:
        return self.num_codebooks * self.nbits_per_codebook / self.group_numel

    def estimate_nbits_per_parameter(self, out_features: int, in_features: int,
                                     scale_nbits: int = 0, codebook_value_nbits: int = 16,
                                     codebook_value_num_groups: int = 1) -> float:
        """Amortized bits per parameter with the codebooks and scales, as
        ``aqlm_tpu``'s accounting (second-level codebook values and quantized
        group-wise scales included)."""
        num_out_groups = out_features // self.out_group_size
        num_in_groups = in_features // self.in_group_size
        num_params = out_features * in_features
        code_bits = num_out_groups * num_in_groups * self.num_codebooks * self.nbits_per_codebook
        codebook_bits = (self.num_codebooks * self.codebook_size * self.group_numel
                         * codebook_value_nbits)
        if codebook_value_nbits < 16:
            codebook_bits += (2 ** codebook_value_nbits * self.num_codebooks
                              * codebook_value_num_groups * self.group_numel * 16)
        if scale_nbits >= 16 or 2 ** scale_nbits >= num_in_groups:  # lossless group scales
            scale_bits_total = scale_nbits * num_out_groups * num_in_groups
        elif 0 < scale_nbits < 16:  # quantized group scales + their 1-D codebook
            scale_bits_total = scale_nbits * num_out_groups * num_in_groups
            scale_bits_total += num_out_groups * 2 ** scale_nbits * 16
        else:  # scale_nbits == 0: one 16-bit scale per output group
            scale_bits_total = num_out_groups * 16
        return (code_bits + codebook_bits + scale_bits_total) / num_params

    def codes_shape(self, out_features: int, in_features: int) -> tuple[int, int, int]:
        self.check_features(out_features, in_features)
        return (
            out_features // self.out_group_size,
            in_features // self.in_group_size,
            self.num_codebooks,
        )

    def codebooks_shape(self) -> tuple[int, int, int, int]:
        return (self.num_codebooks, self.codebook_size, self.out_group_size, self.in_group_size)

    def check_features(self, out_features: int, in_features: int) -> None:
        if out_features % self.out_group_size:
            raise ValueError(
                f"out_features={out_features} not divisible by out_group_size={self.out_group_size}"
            )
        if in_features % self.in_group_size:
            raise ValueError(
                f"in_features={in_features} not divisible by in_group_size={self.in_group_size}"
            )

    @classmethod
    def parse(cls, name: str) -> "AqlmScheme":
        """Parse 'KxN[gG]' shorthand, e.g. '1x16', '2x8g8'."""
        m = _SCHEME_RE.match(name.strip())
        if not m:
            raise ValueError(f"unrecognized scheme name: {name!r}")
        k, n, g = int(m.group(1)), int(m.group(2)), m.group(3)
        return cls(num_codebooks=k, nbits_per_codebook=n, in_group_size=int(g) if g is not None else 8)

    @property
    def name(self) -> str:
        return f"{self.num_codebooks}x{self.nbits_per_codebook}g{self.in_group_size}"

    def __str__(self) -> str:  # pragma: no cover
        return self.name


SCHEME_1X16 = AqlmScheme(1, 16, 8)
SCHEME_2X8 = AqlmScheme(2, 8, 8)
SCHEME_8X8 = AqlmScheme(8, 8, 8)
SCHEME_1X8 = AqlmScheme(1, 8, 8)
