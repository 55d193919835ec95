"""Convert a port checkpoint into a `model.pt` of the reference
implementation (loadable by its Checkpoint.load and evaluate.py).

    python -m gta_tpu_torch.scripts.export_reference_checkpoint \
        runs/clevrtr/GTA/gta/config.yaml runs_out/my_run out/model.pt

Weights and the scalar training state always export. To export the AdamW
moments too (so the reference resumes training with them), pass
--optimizer-order-from with any reference checkpoint of the same
architecture: torch indexes optimizer state by parameter position, which
only a reference file pins down. The rules are in
gta_tpu_torch/utils/ref_import.py. The checkpoint is restored on the card
unless --device cpu is given.
"""

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("config", help="the run's config.yaml")
    p.add_argument("run_dir", help="port run directory (containing ckpts/)")
    p.add_argument("out_pt", help="path of the model.pt to write")
    p.add_argument("--name", default="latest", help="checkpoint slot to read (latest|best|step_N)")
    p.add_argument("--optimizer-order-from", default=None,
                   help="a reference model.pt of the same architecture; enables AdamW moment export")
    p.add_argument("--trusted", action="store_true",
                   help="allow full unpickling of the .pt (can execute embedded code; needed for checkpoints from "
                        "old torch versions carrying numpy scalars)")
    p.add_argument("--device", default=None, help="default: cuda")
    args = p.parse_args(argv)

    from gta_tpu_torch.utils.ref_import import export_reference_checkpoint

    scalars = export_reference_checkpoint(args.config, args.run_dir, args.out_pt, name=args.name,
                                          optimizer_order_from=args.optimizer_order_from, trusted=args.trusted,
                                          device=args.device)
    print(f"Exported {args.run_dir}/ckpts/{args.name} -> {args.out_pt} (it={scalars.get('it')})")


if __name__ == "__main__":
    main()
