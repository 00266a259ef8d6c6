"""PLONKish proof system core (KZG + SHPLONK over BN254) on PyTorch."""
from .assignment import BlindingRng, CircuitData
from .cs import ADVICE, FIXED, INSTANCE, Column, ConstraintSystem
from .domain import Domain
from .keygen import ProvingKey, VerifyingKey, from_reference_pk, keygen
from .kzg import ParamsKZG, gen_srs, setup
from .mock import MockFailure, run_mock
from .prover import create_proof, instance_lagrange
from .verifier import verify_proof
