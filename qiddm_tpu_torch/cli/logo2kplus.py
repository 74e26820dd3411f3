"""Logo-2K+ rebuttal driver (counterpart of
``qiddm_tpu/cli/logo2kplus.py``, reference src/logo2kplus.py):
``python -m qiddm_tpu_torch.cli.logo2kplus --device cuda``.

Labels 1, 4 and 5, as the JAX driver has them: the reference's driver
loops labels 0-2 (src/logo2kplus.py:359), but every Logo-2K+ artifact it
shipped carries labels 1, 4 and 5, and so does the data built from them.
"""

from .rebuttal_common import make_main

parse_args, main = make_main(
    "QDDM on Logo-2K+", default_data="logo2kplus_28x28",
    default_img_size=28, labels=[1, 4, 5], save_prefix="results/for_logo/",
    n_classes=10)

if __name__ == "__main__":
    main()
