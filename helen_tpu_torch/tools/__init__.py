"""Developer and analysis tools.

Equivalents of the reference's helper scripts
(helen/modules/python/helper/): standalone argparse utilities that are not
part of the polishing pipeline but support model development and assembly
quality analysis.

  image_viewer        - ASCII pileup-image renderer (tensor_analyzer.py)
  compare_images      - position-by-position feature/label diff of two image
                        files (hdf5_reader.py's HELEN<->Medaka comparison)
  loss_curves         - train/test CSV summarizer (csv_analyzer.py)
  quast_sv_extractor  - misassembly-vs-known-SV counter (quast_sv_extractor.py)
  assess_summary      - pomoxis assess_assembly summary reducer
                        (assess_summary_analyzer.py)
  vcf_remove_phase    - strip phasing from VCF genotypes (VCF_remove_phase.py)
"""
