"""Convert a checkpoint of the reference implementation (a `model.pt`
written by its Checkpoint.save) into a port run directory.

    python -m gta_tpu_torch.scripts.import_reference_checkpoint \
        runs/clevrtr/GTA/gta/config.yaml /path/to/model.pt out_runs/imported

Afterwards `python -m gta_tpu_torch.train <config> --outdir out_runs/imported`
resumes from the imported weights and AdamW moments at the reference's
iteration count, and `python -m gta_tpu_torch.evaluate <config> --outdir
out_runs/imported --ckpt latest` evaluates them. The translation rules are
in gta_tpu_torch/utils/ref_import.py. The trainer is built on the card
unless --device cpu is given.
"""

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("config", help="the run's config.yaml (same one the reference trained with)")
    p.add_argument("model_pt", help="reference model.pt / model_<it>.pt / model_best.pt")
    p.add_argument("outdir", help="port run directory to create")
    p.add_argument("--name", default="latest",
                   help="checkpoint slot to write (latest|best|step_N; default latest = auto-resume slot)")
    p.add_argument("--no-optimizer", action="store_true", help="skip the AdamW moment transplant (fresh optimizer state)")
    p.add_argument("--trusted", action="store_true",
                   help="allow full unpickling of the .pt (can execute embedded code; needed for checkpoints from "
                        "old torch versions carrying numpy scalars)")
    p.add_argument("--device", default=None, help="default: cuda")
    args = p.parse_args(argv)

    from gta_tpu_torch.utils.ref_import import import_reference_checkpoint

    scalars, counts = import_reference_checkpoint(args.config, args.model_pt, args.outdir,
                                                  import_optimizer=not args.no_optimizer, name=args.name,
                                                  trusted=args.trusted, device=args.device)
    print(f"Imported {args.model_pt} -> {args.outdir}/ckpts/{args.name} "
          f"(it={scalars['it']}, params: encoder {counts['encoder']:,} / decoder {counts['decoder']:,})")


if __name__ == "__main__":
    main()
