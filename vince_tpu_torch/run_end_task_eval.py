"""The end-task evaluation entry point (counterpart of
``run_end_task_eval.py``):

    python -m vince_tpu_torch.run_end_task_eval --solver EndTaskImagenetSolver ... [--platform cpu]

parses the training CLI's flags, builds the solver with no loggers (it
restores the pretrained encoder and the end task's latest checkpoint), runs
``run_eval`` (one complete val pass; for tracking, OTB-2015's one-pass
evaluation of the tracker), prints ``EVAL_RESULT`` and the results as one
JSON object with sorted keys and float values, and ends the solver, also
after a failure.
"""

import json

from vince_tpu_torch import arg_parser
from vince_tpu_torch.solver_runner import get_solver_class


def main(argv=None):
    """Evaluate as the flags say; returns the results."""
    args = arg_parser.parse_args(argv)
    solver = get_solver_class(args.solver or "EndTaskImagenetSolver")(args)
    try:
        res = solver.run_eval()
        if res:
            print("EVAL_RESULT " + json.dumps({k: float(v) for k, v in res.items()},
                                              sort_keys=True))
    finally:
        solver.end()
    return res


if __name__ == "__main__":
    main()
