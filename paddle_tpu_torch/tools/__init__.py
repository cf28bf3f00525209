"""The port's command-line tools (≙ the repo's `tools/` scripts).

Each runs as `python -m paddle_tpu_torch.tools.<name>` from any
directory: `lint_program` (the static analyzer CLI), `recovery_smoke`
(the kill-the-process recovery drill), `demo_trainer` (trains a saved
program), `trace_merge` (per-rank Chrome traces into one timeline) and
`print_signatures` (the public API in `API.spec`'s one-line form). The
tools that build or run a program take `--place {cuda,cpu}`, `cuda` by
default.
"""


def add_place_arg(parser):
    """`--place {cuda,cpu}`, `cuda` by default (the port's entry points
    run on the card unless the caller asks for the CPU)."""
    parser.add_argument("--place", choices=("cuda", "cpu"), default="cuda",
                        help="where programs run: the first CUDA card "
                             "(default; raises without one) or the CPU")


def resolve_place(name: str):
    """The Place `--place` names; CUDAPlace(0) raises without a card, as
    the port's Executor does."""
    from ..core.places import CPUPlace, CUDAPlace, place_to_device
    place = CPUPlace() if name == "cpu" else CUDAPlace(0)
    place_to_device(place)
    return place
